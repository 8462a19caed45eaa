"""The port's L-BFGS (`train.LBFGS`, `npde.lbfgs()`) against `optax.lbfgs()`
as the JAX package's trainer runs it.

Each case builds one problem in both packages from the same numpy-made
parameters and takes L-BFGS steps with the JAX package's `make_step` (the
step its `solve` jits) and the port's, comparing after every step the
parameters, the stepsize the zoom line search chose and the number of its
steps (optax's ``ZoomLinesearchInfo.num_linesearch_steps`` against the
port's state); then the port's `solve` must end where its steps did and,
for the small problems, the JAX package's `solve` there too.
The cases: a bare Rosenbrock problem (25 steps); one-dimensional functions
whose line searches take the cubic, quadratic and bisection steps, the
approximate-decrease switch, an infinite value, and a search that fails at
its 20-step bound, each held to optax's `zoom_linesearch` trial by trial and
then trained; 2-D Poisson on `GridTraining` with jet derivatives, plain
and reweighted; a complex-parameter NNODE step; `solve_hybrid`;
`solve_ensemble`; the first float32 step.

Tolerances: 1e-9 relative in float64 (the same arithmetic in another
order: XLA's reductions against torch's); the line-search counts are equal.
In float32, 1e-5 on the first step: the JAX side runs with x64 on (as the
whole suite does), where optax keeps some line-search scalars in float64
and the port keeps them in float32 (`train.LBFGS`'s docstring).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src import linesearch as optax_linesearch

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, poisson_1d, poisson_2d
from neuralpde_tpu.solvers import ode as jode
from neuralpde_tpu_torch import train
from neuralpde_tpu_torch.adaptive import NonAdaptiveLoss
from neuralpde_tpu_torch.solvers import ode as tode

F64 = torch.float64
TOL = 1e-9


def rel_err(got, want):
    """max |got - want| / max |want|, complex entries kept complex."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


class _Bare:
    """A problem with no `PINNRepresentation`: a loss and parameters."""

    pinnrep = None

    def __init__(self, loss, init_params):
        self._loss, self.init_params = loss, init_params

    def loss(self, theta, lstate):
        return self._loss(theta), {}


def _jax_steps(prob, n):
    """The JAX package's step (`train.make_step`, jitted as `solve` jits
    it) ``n`` times -> per step (params, stepsize, line-search steps)."""
    rep = getattr(prob, "pinnrep", None)
    opt = optax.lbfgs()
    if rep is not None:
        lf = rep.loss_functions
        pde, bc = lf.pde_loss_functions, lf.bc_loss_functions
        ada = rep.adaloss.init_state(len(pde), len(bc), rep.dtype)
        step = jpkg.train.make_step(prob.loss, opt, rep.adaloss, pde, bc)
    else:
        ada = {"pde_weights": jnp.ones((0,)), "bc_weights": jnp.ones((0,)),
               "additional_weights": jnp.ones((1,))}
        step = jpkg.train.make_step(prob.loss, opt)
    step = jax.jit(step)
    carry = (prob.init_params, opt.init(prob.init_params), ada,
             jnp.asarray(0, jnp.int32))
    out = []
    for _ in range(n):
        carry, _ = step(carry, jax.random.key(0))
        search = carry[1][2]
        out.append((tpkg.params_from_jax(jax.tree.map(np.asarray, carry[0])),
                    float(search.learning_rate),
                    int(search.info.num_linesearch_steps)))
    return out


def _port_steps(prob, n):
    """The port's `make_step` with `npde.lbfgs()` ``n`` times, set up as
    `solve` sets it up -> per step (params, stepsize, line-search steps)."""
    rep = getattr(prob, "pinnrep", None)
    if rep is not None:
        lf = rep.loss_functions
        pde, bc = lf.pde_loss_functions, lf.bc_loss_functions
        ada = rep.adaloss.init_state(len(pde), len(bc), rep.dtype, rep.device)
        step = tpkg.make_step(prob.loss, tpkg.lbfgs(), rep.adaloss, pde, bc,
                              matmul_precision=rep.matmul_precision)
    else:
        like = next(iter(prob.init_params.values()))
        ada = NonAdaptiveLoss().init_state(0, 0, like.dtype.to_real(),
                                           like.device)
        step = tpkg.make_step(prob.loss, tpkg.lbfgs())
    carry = step.init(prob.init_params, ada)
    generator = torch.Generator().manual_seed(0)
    out = []
    for _ in range(n):
        carry, _ = step(carry, generator)
        opt = carry[1]
        st = opt.state[opt._params[0]]
        out.append(({k: v.detach().clone() for k, v in carry[0].items()},
                     float(st["learning_rate"]),
                     int(st["num_linesearch_steps"])))
    return out


def _assert_steps_match(jprob, tprob, n, jax_solve=True):
    """Step by step, then the port's `solve` (which must end where its steps
    did) and, with ``jax_solve``, the JAX package's (a compile of its own,
    so the larger problems leave it out: its `solve` jits the same step)
    -> the port's per-step record."""
    want, got = _jax_steps(jprob, n), _port_steps(tprob, n)
    for i, ((jp, jlr, jcount), (tp, tlr, tcount)) in enumerate(zip(want, got)):
        assert tcount == jcount, (i, tcount, jcount)
        assert abs(tlr - jlr) <= TOL * abs(jlr), (i, tlr, jlr)
        for k, v in tp.items():
            assert rel_err(v, jp[k]) < TOL, (i, k)
    tres = tpkg.solve(tprob, tpkg.lbfgs(), maxiters=n)
    for k, v in tres.u.items():
        assert torch.equal(v, got[-1][0][k]), k
    if jax_solve:
        jres = jpkg.solve(jprob, optax.lbfgs(), maxiters=n)
        jfinal = tpkg.params_from_jax(jax.tree.map(np.asarray, jres.u))
        for k, v in tres.u.items():
            assert rel_err(v, jfinal[k]) < TOL, k
    return got


# --- (a) Rosenbrock ----------------------------------------------------------

def test_rosenbrock_follows_optax_step_by_step():
    x0 = np.random.default_rng(0).normal(size=5)

    def jloss(th):
        x = th["x"]
        return jnp.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

    def tloss(th):
        x = th["x"]
        return torch.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

    got = _assert_steps_match(_Bare(jloss, {"x": jnp.asarray(x0)}),
                              _Bare(tloss, {"x": torch.tensor(x0)}), 25)
    # the zoom ran (a stepsize other than the first guess of 1)
    assert any(count > 1 for _, _, count in got)


def test_a_torch_lbfgs_factory_still_trains_through_solve():
    """`solve` takes any optimizer factory: `torch.optim.LBFGS` (strong
    Wolfe) runs through the same closure, eagerly, and descends."""
    x0 = np.random.default_rng(0).normal(size=5)
    prob = _Bare(lambda th: torch.sum(100 * (th["x"][1:] - th["x"][:-1] ** 2)
                                      ** 2 + (1 - th["x"][:-1]) ** 2),
                 {"x": torch.tensor(x0)})
    res = tpkg.solve(prob, lambda ps: torch.optim.LBFGS(
        list(ps), max_iter=1, max_eval=21, line_search_fn="strong_wolfe"),
        maxiters=10)
    assert res.history[-1] < res.history[0]


# --- (b) one-dimensional line searches --------------------------------------

FUNCTIONS = {
    # name: (f(x, xp), x0, direction u, what the search must do)
    "tanh": (lambda x, xp: -xp.tanh(5 * x) + 0.01 * x ** 2, -1.0, 10.0,
             {"cubic", "quad", "bisect"}),
    "quartic": (lambda x, xp: x ** 4, 1.0, -40.0, {"bisect", "cubic"}),
    "cos": (lambda x, xp: -xp.cos(x - 0.7), 1.0, -30.0, {"quad", "cubic"}),
    # the value rounds to the start's: the Armijo test fails, the
    # approximate decrease holds
    "flat": (lambda x, xp: 1e8 + x ** 2, 1e-5, -1e-5, {"approx"}),
    # curvature never met while doubling: fails at 20 with a safe stepsize
    "unbounded": (lambda x, xp: x ** 3 - 3 * x + xp.exp(x), 0.0, -3.0,
                  {"failed"}),
    # an ascent direction: bisects to the bound, no stepsize of sufficient
    # decrease
    "ascent": (lambda x, xp: x ** 2, 1.0, 1.0, {"failed", "bisect"}),
    # infinite values beyond -0.5
    "domain": (lambda x, xp: xp.where(x > -0.5, x ** 2, np.inf), 1.0, -10.0,
               {"bisect"}),
}


def _optax_search(f, x0, u):
    """optax's `zoom_linesearch` step by step -> (trial stepsizes, branches
    taken, stepsize, steps, decrease and curvature errors)."""
    init, step_fn, cond = optax_linesearch.zoom_linesearch(
        max_linesearch_steps=train.LBFGS_LINESEARCH_STEPS)
    vg = jax.value_and_grad(f)
    step = jax.jit(lambda s: step_fn(s, value_and_grad_fn=vg, fn_kwargs={}))
    x0, u = jnp.float64(x0), jnp.float64(u)
    value, grad = vg(x0)
    s = init(u, x0, value=value, grad=grad)
    trials, kinds = [], set()
    while bool(cond(s)):
        if bool(s.interval_found):
            d = abs(s.high - s.low)
            left, right = min(s.high, s.low), max(s.high, s.low)
            c = optax_linesearch._cubicmin(s.low, s.value_low, s.slope_low,
                                           s.high, s.value_high, s.cubic_ref,
                                           s.value_cubic_ref)
            q = optax_linesearch._quadmin(s.low, s.value_low, s.slope_low,
                                          s.high, s.value_high)
            kinds.add("cubic" if left + 0.2 * d < c < right - 0.2 * d else
                      "quad" if left + 0.1 * d < q < right - 0.1 * d else
                      "bisect")
        s = step(s)
        trials.append(float(s.stepsize))
    if bool(s.failed):
        kinds.add("failed")
        trials.pop()        # the safe step replaced the last trial
    return (trials, kinds, float(s.stepsize), int(s.count),
            float(s.decrease_error), float(s.curvature_error))


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_zoom_line_search_follows_optax_on_one_dimensional_functions(name):
    fn, x0, u, expect = FUNCTIONS[name]
    trials, kinds, stepsize, count, dec, curv = _optax_search(
        lambda x: fn(x, jnp), x0, u)
    x0t, ut = torch.tensor(x0, dtype=F64), torch.tensor(u, dtype=F64)
    seen = []

    def evaluate(eta):
        seen.append(float(eta))
        x = (x0t + float(eta) * ut).requires_grad_(True)
        value = fn(x, torch)
        (g,) = torch.autograd.grad(value, x)
        return value.detach().numpy()[()], (g * ut).numpy()[()]

    x = x0t.clone().requires_grad_(True)
    value = fn(x, torch)
    (g,) = torch.autograd.grad(value, x)
    got = train.zoom_linesearch(value.detach().numpy()[()],
                                (ut * g).numpy()[()], evaluate)
    assert len(seen) == count
    assert rel_err(np.asarray(seen[:len(trials)]), np.asarray(trials)) < TOL
    assert got[1] == count
    assert abs(got[0] - stepsize) <= TOL * abs(stepsize)
    for a, b in ((got[2], dec), (got[3], curv)):
        assert a == b or abs(a - b) <= TOL * abs(b)
    if "approx" in expect:
        # Armijo's test alone fails at the accepted stepsize
        v1 = fn(x0 + stepsize * u, np)
        v0, s0 = fn(x0, np), 2 * x0 * u
        assert v1 - v0 - train._SLOPE_RTOL * stepsize * s0 > 0
        assert dec == 0.0 and count == 1
    else:
        assert expect <= kinds, kinds
    if name == "ascent":
        assert dec > 0 and count == train.LBFGS_LINESEARCH_STEPS
    if name == "unbounded":
        assert dec == 0 and curv > 0 and count == train.LBFGS_LINESEARCH_STEPS


@pytest.mark.parametrize("name", ["tanh", "cos", "domain"])
def test_one_dimensional_functions_train_like_jax(name):
    """The same functions under `solve`: L-BFGS's own directions, 4 steps."""
    fn, x0, _, _ = FUNCTIONS[name]
    _assert_steps_match(
        _Bare(lambda th: jnp.sum(fn(th["x"], jnp)),
              {"x": jnp.asarray([x0])}),
        _Bare(lambda th: torch.sum(fn(th["x"], torch)),
              {"x": torch.tensor([x0], dtype=F64)}), 4,
        jax_solve=name == "tanh")


# --- (c) 2-D Poisson on a grid, plain and reweighted ------------------------

def _poisson_pair(adaptive=False, sizes=(2, 8, 8, 1), dtype="float64",
                  seed=0):
    tree = mlp_params(np.random.default_rng(seed), list(sizes))
    jdt, tdt = {"float64": (jnp.float64, F64),
                "float32": (jnp.float32, torch.float32)}[dtype]
    jada = jpkg.GradientScaleAdaptiveLoss(3) if adaptive else None
    tada = tpkg.GradientScaleAdaptiveLoss(3) if adaptive else None
    jprob = jpkg.discretize(poisson_2d(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp(list(sizes)), jpkg.GridTraining(0.25), init_params=tree,
        derivative="jet", dtype=jdt, adaptive_loss=jada))
    tprob = tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp(list(sizes), dtype=tdt), tpkg.GridTraining(0.25),
        init_params=tpkg.params_from_jax(tree), derivative="jet", dtype=tdt,
        adaptive_loss=tada, device="cpu"))
    return jprob, tprob


@pytest.mark.parametrize("adaptive", [False, True], ids=["plain", "gradscale"])
def test_poisson_grid_jet_follows_optax(adaptive):
    jprob, tprob = _poisson_pair(adaptive)
    _assert_steps_match(jprob, tprob, 10, jax_solve=False)


# --- (d) complex parameters --------------------------------------------------

def test_complex_nnode_step_follows_optax():
    """u' = i u with complex parameters, one step.  The JAX package's
    `Dense` keeps only Re(W0)·t for a real time grid (ROADMAP, reference
    faults), so its objective is built on the same grid held as complex
    numbers, where it equals the port's (both with forward-mode du/dt)."""
    rng = np.random.default_rng(11)
    sizes = [1, 8, 1]
    re, im = mlp_params(rng, sizes), mlp_params(rng, sizes)
    tree = jax.tree.map(lambda a, b: a + 0.3j * b, re, im)
    u0, tspan = np.complex128(1.0), (0.0, 2.0)
    before = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    try:
        tprob = tpkg.ODEProblem(lambda u, p, t: 1j * u, u0, tspan)
        talg = tpkg.NNODE(tpkg.mlp(sizes, dtype=torch.complex128),
                          tpkg.lbfgs(), autodiff=True,
                          init_params=tpkg.params_from_jax(tree))
        tloss, ttheta, _ = tode.build_ode_loss(tprob, talg, dt=0.1,
                                               device="cpu")
        jprob = jpkg.ODEProblem(lambda u, p, t: 1j * u, u0, tspan)
        jphi = jode.ODEPhi(jpkg.mlp(sizes), 0.0, u0)
        jloss = jode._strategy_loss(jpkg.GridTraining(0.1), jphi, jprob.f,
                                    True, tspan, None, False, True,
                                    jnp.complex128)
        theta0 = {"depvar": jax.tree.map(jnp.asarray, tree)}
        got = _assert_steps_match(
            _Bare(lambda th: jloss(th, None), theta0),
            _Bare(lambda th: tloss(th, None), ttheta), 1, jax_solve=False)
    finally:
        torch.set_default_dtype(before)
    assert all(v.is_complex() for v in got[0][0].values())


# --- (e) solve_hybrid --------------------------------------------------------

def test_solve_hybrid_follows_the_jax_package():
    """20 Adam then 20 L-BFGS steps, one step a block: the loss before every
    step and the parameters at the end."""
    tree = mlp_params(np.random.default_rng(4), [1, 8, 1])
    jprob = jpkg.discretize(poisson_1d(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp([1, 8, 1]), jpkg.GridTraining(0.1), init_params=tree,
        derivative="jet", dtype=jnp.float64))
    tprob = tpkg.discretize(poisson_1d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([1, 8, 1], dtype=F64), tpkg.GridTraining(0.1),
        init_params=tpkg.params_from_jax(tree), derivative="jet", dtype=F64,
        device="cpu"))
    kw = dict(adam_iters=20, lbfgs_iters=20, adam_lr=2e-2, inner_steps=1)
    jres, tres = jpkg.solve_hybrid(jprob, **kw), tpkg.solve_hybrid(tprob, **kw)
    assert tres.iterations == 40 and len(tres.history) == 40
    assert rel_err(np.asarray(tres.history), np.asarray(jres.history)) < TOL
    want = tpkg.params_from_jax(jax.tree.map(np.asarray, jres.u))
    for k, v in tres.u.items():
        assert rel_err(v, want[k]) < TOL, k


# --- (f) ensembles -----------------------------------------------------------

def test_ensemble_members_follow_the_jax_ensemble_and_solo_solves():
    """Two members, 5 steps, one step a block: each member's losses and
    parameters against the JAX package's vmapped `optax.lbfgs`, and against
    the port's solo `solve` from the member's parameters."""
    sizes = [1, 12, 1]
    rng = np.random.default_rng(1)
    trees = [mlp_params(rng, sizes) for _ in range(2)]
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *trees)
    key = jax.random.key(7)
    keys = jax.random.key_data(jax.vmap(
        lambda m: jax.random.fold_in(key, m))(jnp.arange(2)))

    def jinit(k):
        m = jnp.argmax(jnp.all(keys == jax.random.key_data(k), axis=1))
        return {"depvar": jax.tree.map(lambda s: s[m], stacked)}

    jprob = jpkg.discretize(poisson_1d(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp(sizes), jpkg.GridTraining(0.1), dtype=jnp.float64))
    jres = jpkg.solve_ensemble(jprob, optax.lbfgs(), maxiters=5,
                               n_ensemble=2, key=key, member_init=jinit)
    inits = [{f"depvar.{k}": v for k, v in
              tpkg.params_from_jax(t, dtype=F64).items()} for t in trees]
    flats = iter(inits)
    tprob = tpkg.discretize(poisson_1d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp(sizes, dtype=F64), tpkg.GridTraining(0.1), dtype=F64,
        device="cpu"))
    res = tpkg.solve_ensemble(tprob, tpkg.lbfgs(), maxiters=5, n_ensemble=2,
                              member_init=lambda g: next(flats))
    for (it, losses), (jit, jlosses) in zip(res.history, jres.history):
        assert it == jit and rel_err(losses, np.asarray(jlosses)) < TOL
    want = tpkg.params_from_jax(jax.tree.map(np.asarray, jres.members),
                                dtype=F64)
    for k, v in res.members.items():
        assert rel_err(v, want[k]) < TOL, k
    for m in range(2):
        solo = tpkg.solve(tprob.with_params(inits[m]), tpkg.lbfgs(),
                          maxiters=5)
        for k, v in solo.u.items():
            assert rel_err(res.member(m)[k], v) < 1e-10, (m, k)


# --- (g) float32 -------------------------------------------------------------

def test_first_float32_step_follows_optax():
    jprob, tprob = _poisson_pair(dtype="float32")
    (jp, jlr, jcount), = _jax_steps(jprob, 1)
    (tp, tlr, tcount), = _port_steps(tprob, 1)
    assert tcount == jcount and abs(tlr - jlr) <= 1e-5 * abs(jlr)
    for k, v in tp.items():
        assert v.dtype == torch.float32
        assert rel_err(v, jp[k]) < 1e-5, k
