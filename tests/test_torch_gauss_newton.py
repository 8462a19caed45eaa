"""The port's matrix-free Gauss-Newton against the JAX package, mirroring
tests/test_gauss_newton.py: the residual-vector invariant, the LSQR and CG
inner solvers, LM objective histories, the trust region, the separable
accuracy floor and the rejection cases.

Tolerances: ``||r||²`` equals the full loss to 1e-12 relative; the inner
solvers agree with JAX's to 1e-10 on well-conditioned systems; LM objective
values after steps to 1e-8 (float64).  The LM comparison uses LSQR: CG on
the normal equations squares the Jacobian's condition number, and its
iterates drift apart at ~1e-5 between two correct implementations that
only round differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import hard as _hard
from _torch_parity import poisson_2d_hard, rel_err, tree_like
from neuralpde_tpu.gauss_newton import _damped_lsqr as j_lsqr
from neuralpde_tpu_torch.gauss_newton import _cg, _damped_lsqr

F64 = torch.float64


def _tree(jnet, seed):
    return tree_like(jnet.init(jax.random.key(0)),
                     np.random.default_rng(seed))


def poisson_1d(pkg):
    x = pkg.symbols("x")
    u = pkg.DepVar("u")
    return pkg.PDESystem(
        pkg.Eq((pkg.Differential(x) ** 2)(u(x)),
               -(np.pi ** 2) * pkg.sin(np.pi * x)),
        [pkg.Eq(u(0.0), 0.0), pkg.Eq(u(1.0), 0.0)],
        [pkg.Domain(x, pkg.Interval(0, 1))], [x], [u(x)])


def poisson_2d(pkg):
    """`poisson_2d_hard` with u = 0 at x = 0 and x = 1."""
    system = poisson_2d_hard(pkg)
    x, y = pkg.symbols("x y")
    u = pkg.DepVar("u")
    return pkg.PDESystem(system.eqs, [pkg.Eq(u(0.0, y), 0.0),
                                      pkg.Eq(u(1.0, y), 0.0)],
                         system.domains, system.ivs, system.dvs)


def _dense(pkg, kw):
    return pkg.mlp([1, 16, 16, 1], **kw)


def _problems(system, builder, strategy, seed=0, dtype=F64,
              pkg_kw=lambda pkg: {}, **kw):
    jnet = builder(jpkg, {})
    tree = _tree(jnet, seed)
    jdt = jnp.float64 if dtype == F64 else jnp.float32
    jprob = jpkg.discretize(system(jpkg), jpkg.PhysicsInformedNN(
        jnet, strategy(jpkg), init_params=tree, dtype=jdt, **pkg_kw(jpkg),
        **kw))
    tprob = tpkg.discretize(system(tpkg), tpkg.PhysicsInformedNN(
        builder(tpkg, {"dtype": dtype}), strategy(tpkg),
        init_params=tpkg.params_from_jax(tree), dtype=dtype, **pkg_kw(tpkg),
        **kw, device="cpu"))
    return jprob, tprob


def _full_loss(prob, n_bc):
    ada = prob.pinnrep.adaloss.init_state(1, n_bc, prob.pinnrep.dtype,
                                          prob.pinnrep.device)
    return float(prob.loss(prob.init_params,
                           {"generator": None, "adaptive": ada})[0])


RESIDUAL_CASES = {
    "grid_weighted": (poisson_1d, _dense, lambda pkg: pkg.GridTraining(0.05),
                      dict(pkg_kw=lambda pkg: dict(
                          adaptive_loss=pkg.NonAdaptiveLoss(
                              pde_loss_weights=2.0,
                              bc_loss_weights=[3.0, 5.0])))),
    "grid_gpinn": (poisson_1d, _dense, lambda pkg: pkg.GridTraining(0.1),
                   dict(gradient_enhanced=0.3, derivative="jet")),
    "separable": (poisson_2d, lambda pkg, kw: pkg.separable_mlp(2, (8,), 4,
                                                                **kw),
                  lambda pkg: pkg.SeparableTraining(dx=1 / 8), {}),
}


@pytest.mark.parametrize("name", sorted(RESIDUAL_CASES))
def test_norm_squared_equals_full_loss_and_jax(name):
    system, builder, strategy, kw = RESIDUAL_CASES[name]
    jprob, tprob = _problems(system, builder, strategy, seed=1, **kw)
    r = tpkg.build_residual_vector(tprob.pinnrep)(tprob.init_params)
    assert rel_err(float(torch.sum(r * r)), _full_loss(tprob, 2)) < 1e-12
    want = np.asarray(jpkg.build_residual_vector(jprob.pinnrep)(
        jprob.init_params))
    assert r.shape == want.shape
    assert rel_err(r.numpy(), want) < 1e-10


def test_damped_lsqr_matches_jax_and_the_normal_equations():
    rng = np.random.default_rng(0)
    A, b = rng.normal(size=(40, 12)), rng.normal(size=(40,))
    lam = 0.3
    want = np.linalg.solve(A.T @ A + lam * np.eye(12), A.T @ b)
    At, bt = torch.tensor(A), torch.tensor(b)
    got = _damped_lsqr(lambda x: At @ x, lambda y: At.T @ y, bt,
                       np.sqrt(lam), iters=60)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8)
    jgot = j_lsqr(lambda x: jnp.asarray(A) @ x, lambda y: jnp.asarray(A).T @ y,
                  jnp.asarray(b), np.sqrt(lam), iters=20)
    got = _damped_lsqr(lambda x: At @ x, lambda y: At.T @ y, bt,
                       np.sqrt(lam), iters=20)
    assert rel_err(got.numpy(), np.asarray(jgot)) < 1e-10
    # mixed precision: float32 products, float64 recurrence
    A32 = At.float()
    mixed = _damped_lsqr(lambda x: A32 @ x, lambda y: A32.T @ y, bt.float(),
                         np.sqrt(lam), iters=60, hi=F64)
    assert mixed.dtype == torch.float32
    np.testing.assert_allclose(mixed.numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("precondition", [False, True])
def test_cg_matches_jax_cg_with_its_early_stop(precondition):
    rng = np.random.default_rng(1)
    Q = rng.normal(size=(30, 30))
    A = Q @ Q.T / 30 + np.diag(np.linspace(0.5, 3.0, 30))
    b = rng.normal(size=(30,))
    inv = 1.0 / np.diag(A)
    M = (lambda p: jnp.asarray(inv) * p) if precondition else None
    tM = (lambda p: torch.tensor(inv) * p) if precondition else None
    At = torch.tensor(A)
    for maxiter in (5, 200):        # cut short, and stopped by the tolerance
        want, _ = jax.scipy.sparse.linalg.cg(lambda p: jnp.asarray(A) @ p,
                                             jnp.asarray(b), maxiter=maxiter,
                                             M=M)
        got = _cg(lambda p: At @ p, torch.tensor(b), maxiter, tM)
        assert rel_err(got.numpy(), np.asarray(want)) < 1e-10, maxiter
    r = A @ got.numpy() - b
    assert np.dot(r, r) <= 1e-10 * np.dot(b, b) * 1.01


def _hard_separable(pkg, kw):
    return pkg.SeparableNet([pkg.Transformed(pkg.mlp([1, 8, 8, 6], **kw),
                                             _hard) for _ in range(2)])


@pytest.mark.parametrize("name", ["separable_hard", "dense_1d"])
def test_first_lm_objectives_match_jax(name):
    if name == "separable_hard":
        jprob, tprob = _problems(poisson_2d_hard, _hard_separable,
                                 lambda pkg: pkg.SeparableTraining(dx=1 / 12),
                                 seed=2)
    else:
        jprob, tprob = _problems(poisson_1d, _dense,
                                 lambda pkg: pkg.GridTraining(0.05), seed=3)
    kw = dict(maxiters=5, cg_iters=30, solver="lsqr")
    jres = jpkg.solve_gauss_newton(jprob, **kw)
    tres = tpkg.solve_gauss_newton(tprob, **kw)
    assert len(tres.history) == 6 and tres.iterations == 5
    assert rel_err(tres.history, jres.history) < 1e-8
    assert tres.history[-1] < 0.7 * tres.history[0]


def test_preconditioned_first_step_with_jax_probes_matches():
    jprob, tprob = _problems(poisson_1d, _dense,
                             lambda pkg: pkg.GridTraining(0.05), seed=4)

    def jax_probes(n, dtype, device):
        return torch.tensor(np.asarray(jax.random.rademacher(
            jax.random.key(0), (8, n), jnp.float64)), dtype=dtype)

    kw = dict(maxiters=1, cg_iters=4, precondition=True)
    jres = jpkg.solve_gauss_newton(jprob, **kw)
    tres = tpkg.solve_gauss_newton(tprob, probes=jax_probes, **kw)
    assert rel_err(tres.history, jres.history) < 1e-8


def test_preconditioned_cg_converges():
    """The JAX test's bar (objective < 1e-4) from the port's own seeded
    initial parameters, with the default probes."""
    prob = tpkg.discretize(poisson_1d(tpkg), tpkg.PhysicsInformedNN(
        _dense(tpkg, {"dtype": F64}), tpkg.GridTraining(0.05), dtype=F64,
        device="cpu"))
    res = tpkg.solve_gauss_newton(prob, maxiters=20, cg_iters=50,
                                  precondition=True)
    assert res.objective < 1e-4, res.objective


def test_trust_region_converges_without_ascent():
    _, tprob = _problems(poisson_1d, _dense, lambda pkg: pkg.GridTraining(0.05),
                         seed=5)
    res = tpkg.solve_gauss_newton(tprob, method="tr", maxiters=30,
                                  cg_iters=60)
    xs = np.linspace(0, 1, 101)
    up = tprob.pinnrep.phi(torch.tensor(xs)[None, :],
                           tpkg.depvar_params(res.u)).numpy().ravel()
    assert np.max(np.abs(up - np.sin(np.pi * xs))) < 1e-3
    assert res.objective < 1e-4 and res.aux["inner_iterations"] > 0
    assert all(b <= a for a, b in zip(res.history, res.history[1:]))


def test_separable_2d_reaches_adam_unreachable_floor():
    """The JAX test's bar: the hard-constrained separable Poisson problem to
    rel L2 < 1e-3 against sin(pi x) sin(pi y) / (2 pi^2)."""
    net = tpkg.SeparableNet([tpkg.Transformed(
        tpkg.mlp([1, 24, 24, 24], dtype=F64), _hard) for _ in range(2)])
    prob = tpkg.discretize(poisson_2d_hard(tpkg), tpkg.PhysicsInformedNN(
        net, tpkg.SeparableTraining(dx=1 / 32), dtype=F64, device="cpu"))
    # LSQR reaches the bar in fewer products than the JAX test's CG budget
    # (60 x 100): rel L2 3.8e-4 at 25 x 60 in float64
    res = tpkg.solve_gauss_newton(prob, maxiters=25, cg_iters=60,
                                  solver="lsqr")
    xs = np.linspace(0, 1, 65)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    up = net.grid(tpkg.depvar_params(res.u), [xs, xs]).numpy()
    ua = np.sin(np.pi * X) * np.sin(np.pi * Y) / (2 * np.pi ** 2)
    rel = float(np.linalg.norm(up - ua) / np.linalg.norm(ua))
    assert rel < 1e-3, rel
    assert all(b <= a for a, b in zip(res.history, res.history[1:]))


def _separable_problem(**strategy):
    x, y = tpkg.symbols("x y")
    u = tpkg.DepVar("u")
    system = tpkg.PDESystem(
        tpkg.Eq((tpkg.Differential(x) ** 2)(u(x, y)), u(x, y)), [],
        [tpkg.Domain(x, tpkg.Interval(0, 1)), tpkg.Domain(y, tpkg.Interval(0, 1))],
        [x, y], [u(x, y)])
    ge = strategy.pop("gradient_enhanced", None)
    return tpkg.discretize(system, tpkg.PhysicsInformedNN(
        tpkg.separable_mlp(2, (8,), 4), tpkg.SeparableTraining(**strategy),
        gradient_enhanced=ge, device="cpu"))


class TestRejections:
    def test_stochastic_strategy_rejected(self):
        prob = tpkg.discretize(poisson_1d(tpkg), tpkg.PhysicsInformedNN(
            _dense(tpkg, {}), tpkg.StochasticTraining(64), device="cpu"))
        with pytest.raises(TypeError, match="deterministic"):
            tpkg.build_residual_vector(prob.pinnrep)

    @pytest.mark.parametrize("strategy, match", [
        (dict(points=8, resample=True), "deterministic"),
        (dict(dx=1 / 8, causal="y"), "causal"),
        (dict(dx=1 / 8, gradient_enhanced=0.1), "gPINN"),
    ], ids=["resampled", "causal", "gpinn"])
    def test_separable_variants_rejected(self, strategy, match):
        prob = _separable_problem(**strategy)
        with pytest.raises(ValueError, match=match):
            tpkg.build_residual_vector(prob.pinnrep)

    def test_solver_options_checked(self):
        _, tprob = _problems(poisson_1d, _dense,
                             lambda pkg: pkg.GridTraining(0.2))
        with pytest.raises(ValueError, match="lsqr"):
            tpkg.solve_gauss_newton(tprob, scalar_dtype=F64, solver="cg")
        with pytest.raises(ValueError, match="CG-only"):
            tpkg.solve_gauss_newton(tprob, solver="lsqr", precondition=True)
        with pytest.raises(ValueError, match="'cg' or 'lsqr'"):
            tpkg.solve_gauss_newton(tprob, solver="qr")
        with pytest.raises(ValueError, match="'lm' or 'tr'"):
            tpkg.solve_gauss_newton(tprob, method="bfgs")
        with pytest.raises(ValueError, match="eta"):
            tpkg.solve_gauss_newton(tprob, method="tr", eta=0.3)

    def test_float32_warns_only_without_highest_precision(self):
        import warnings

        _, prob = _problems(poisson_1d, _dense,
                            lambda pkg: pkg.GridTraining(0.2),
                            dtype=torch.float32)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            tpkg.solve_gauss_newton(prob, maxiters=1, cg_iters=2)
        for precision in (None, "high"):
            with pytest.warns(UserWarning, match="float32"):
                tpkg.solve_gauss_newton(prob, maxiters=1, cg_iters=2,
                                        matmul_precision=precision)

    def test_mixed_precision_lsqr_trains_a_float32_problem(self):
        _, prob = _problems(poisson_1d, _dense,
                            lambda pkg: pkg.GridTraining(0.05),
                            dtype=torch.float32, seed=6)
        res = tpkg.solve_gauss_newton(prob, maxiters=20, cg_iters=60,
                                      solver="lsqr", scalar_dtype=F64)
        assert res.u["depvar.layer_0.weight"].dtype == torch.float32
        assert res.objective < 1e-3 * res.history[0]
