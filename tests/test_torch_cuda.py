"""The port's CUDA kernels on the card, against their plain PyTorch versions;
Gauss-Newton's CUDA-graph inner solve against the same solve step by step;
and `solve`'s captured training step (eager against replayed, fresh points
per replay, the reweighting graph, a capture that fails, the spans of the
capture and the replays); the `zoom_step`
kernel against its plain version, and `npde.lbfgs()` captured (against the
CPU, with no host read in a block, restored from a checkpoint); one rate of
`bench_torch.py` and its matmul-ceiling probe; the `sq_sum` kernel against
its plain version and the SPINN Poisson's captured solve on the factored
route.
Graph against eager steps: rtol 1e-6 (the same kernels on the same inputs).

These tests need a CUDA device and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 rtol 1e-5, atol 1e-6 (`tanhf` and torch's tanh differ by
a few ulp, and s = 1 - a^2 cancels for large |z|); float64 1e-12.
"""

import json

import numpy as np
import pytest
import torch

from neuralpde_tpu_torch.kernels import tanh_jet as tj

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.float64: dict(rtol=1e-12, atol=1e-12)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(scale=2.0, size=shape), dtype=dtype,
                         device=device) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(64, 4099), (3, 5)], ids=str)
def test_tanh_jet2_kernel_matches_plain(cuda, dtype, shape):
    zs = [t.requires_grad_(True) for t in _inputs(shape, dtype, cuda)]
    before = tj.tanh_jet2.launches
    out = tj.tanh_jet2(*zs)
    cot = [torch.randn_like(o) for o in out]
    grads = torch.autograd.grad(out, zs, cot)
    torch.cuda.synchronize()
    assert tj.tanh_jet2.launches == before + 2
    plain = tj.tanh_jet2_reference(*(t.detach() for t in zs))
    plain_g = tj.tanh_jet2_backward_reference(*(t.detach() for t in zs), *cot)
    for g, w in zip(list(out) + list(grads), list(plain) + list(plain_g)):
        torch.testing.assert_close(g.detach(), w, **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tanh_jet2_jvp_kernel_matches_plain(cuda, dtype):
    zs = _inputs((64, 4099), dtype, cuda)
    ts = _inputs((64, 4099), dtype, cuda, seed=1)
    before = tj.tanh_jet2_jvp_cuda.launches
    _, got = torch.func.jvp(tj.tanh_jet2, tuple(zs), tuple(ts))
    torch.cuda.synchronize()
    assert tj.tanh_jet2_jvp_cuda.launches == before + 1
    want = tj.tanh_jet2_jvp_reference(*zs, *ts)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL[dtype])


@pytest.mark.cuda
def test_tanh_jet2_vmap_rule_runs_the_kernels_on_the_batch(cuda):
    zs = _inputs((64, 513), torch.float64, cuda)
    batch = [torch.stack([t, 2 * t, -t]) for t in _inputs((64, 513),
                                                           torch.float64,
                                                           cuda, seed=2)]
    before = tj.tanh_jet2_jvp_cuda.launches
    got = torch.func.vmap(lambda *t: torch.func.jvp(
        tj.tanh_jet2, tuple(zs), t)[1])(*batch)
    torch.cuda.synchronize()
    assert tj.tanh_jet2_jvp_cuda.launches == before + 1
    for i in range(3):
        want = tj.tanh_jet2_jvp_reference(*zs, *(b[i] for b in batch))
        for g, w in zip(got, want):
            torch.testing.assert_close(g[i], w, **TOL[torch.float64])


@pytest.mark.cuda
def test_tanh_jet2_kernel_rejects_what_it_does_not_take(cuda):
    z, z1, z2 = _inputs((8, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tj.tanh_jet2_forward_cuda(z.t(), z1.t(), z2.t())
    with pytest.raises(ValueError, match="share device, dtype and shape"):
        tj.tanh_jet2_forward_cuda(z, z1.double(), z2)
    with pytest.raises(ValueError, match="unsupported"):
        tj.tanh_jet2_forward_cuda(z.half(), z1.half(), z2.half())


# sq_sum and the plain version both sum squares in float64, in other
# orders: over 2.7e8 terms they part by ~1e-14 relative
SQ_SUM_RTOL = 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(16384, 16384), (1023, 1029), (3, 5)],
                         ids=str)
def test_sq_sum_kernel_matches_plain(cuda, dtype, shape):
    """`sq_sum` against its plain version, twice bit-equal to itself, and
    from a start that is not 16-byte aligned."""
    from neuralpde_tpu_torch.kernels import sq_sum as sq

    r = torch.randn(shape, dtype=dtype, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    before = sq.sq_sum_cuda.launches
    got, again = sq.sq_sum(r), sq.sq_sum(r)
    torch.cuda.synchronize()
    assert sq.sq_sum_cuda.launches == before + 2
    assert ("sq_sum", shape) in sq.LAUNCH_SHAPES
    assert got.dtype == torch.float64 and got.shape == ()
    assert float(got) == float(again)
    torch.testing.assert_close(got, sq.sq_sum_reference(r), rtol=SQ_SUM_RTOL,
                               atol=0)
    shifted = r.reshape(-1)[1:]
    torch.testing.assert_close(sq.sq_sum(shifted),
                               sq.sq_sum_reference(shifted),
                               rtol=SQ_SUM_RTOL, atol=0)


@pytest.mark.cuda
def test_sq_sum_kernel_rejects_what_it_does_not_take(cuda):
    from neuralpde_tpu_torch.kernels import sq_sum as sq

    with pytest.raises(ValueError, match="contiguous"):
        sq.sq_sum(torch.ones(4, 6, device=cuda).T)
    with pytest.raises(ValueError, match="dtype"):
        sq.sq_sum(torch.ones(4, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="not CUDA"):
        sq.sq_sum_cuda(torch.ones(4))


@pytest.mark.cuda
def test_factored_msq_on_the_card_matches_the_cpu(cuda):
    """`factored_msq`'s value and both factors' gradients, float64, card
    against CPU (where the plain sum of squares runs)."""
    from neuralpde_tpu_torch.compile.separable import factored_msq

    rng = np.random.default_rng(4)
    a0, b0 = rng.normal(size=(12, 300)), rng.normal(size=(12, 257))
    out = []
    for device in ("cpu", cuda):
        a = torch.tensor(a0, device=device, requires_grad=True)
        b = torch.tensor(b0, device=device, requires_grad=True)
        loss = factored_msq(a, b, None, a.shape[0])
        out.append([loss.detach().cpu(), *(g.cpu() for g in
                                           torch.autograd.grad(loss, (a, b)))])
    for got, want in zip(out[1], out[0]):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0)


@pytest.mark.cuda
def test_captured_spinn_solve_takes_the_factored_route(cuda):
    """bench's SPINN Poisson at 1024^2: its one loss takes the factored
    route; the eager step and the capture launch `sq_sum` through the
    wrapper, and every step runs it once on the card (a trace of the
    solve); the replayed losses equal eager steps'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.accuracy import poisson_spinn
    from neuralpde_tpu_torch.kernels import sq_sum as sq

    prob, _ = poisson_spinn(1024, 16, 16, device=cuda)
    assert prob.pinnrep.strategy.routes == ["factored"]
    losses, theta, _ = _eager(prob, 6, seed=0)
    before = sq.sq_sum_cuda.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = npde.solve(prob, npde.adam(1e-3), maxiters=6, inner_steps=3)
        torch.cuda.synchronize()
    assert sq.sq_sum_cuda.launches == before + 2
    assert res.aux["cuda_graph"]["replays"] == 5
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and "sq_sum_partial_kernel" in e.name]
    assert len(kernels) == 6
    np.testing.assert_allclose(res.history, [losses[2], losses[5]],
                               rtol=1e-6)
    for k, v in theta.items():
        torch.testing.assert_close(res.u[k], v, rtol=1e-6, atol=1e-7)


def _inner_solve(kind, A, b, iters):
    """One inner solve of Gauss-Newton on the operator ``A`` (``A x ~ b``),
    on a side stream as `lm_least_squares` runs it."""
    from neuralpde_tpu_torch import gauss_newton as gn

    with gn._side_stream(b):
        if kind == "lsqr":
            damp = torch.tensor(0.3, dtype=b.dtype, device=b.device)
            x = gn._damped_lsqr(lambda v: A @ v, lambda u: A.T @ u, b, damp,
                                iters)
        else:
            N = A.T @ A + 0.1 * torch.eye(A.shape[1], dtype=A.dtype,
                                          device=A.device)
            inv = 1.0 / torch.diagonal(N)
            M = (lambda r: inv * r) if kind == "cg_jacobi" else None
            x = gn._cg(lambda p: N @ p, A.T @ b, iters, M)
    if b.is_cuda:
        torch.cuda.synchronize()
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("kind,iters", [("lsqr", 10), ("cg", 25),
                                        ("cg_jacobi", 25)])
def test_gauss_newton_inner_solve_graph_replay_matches_eager(
        cuda, monkeypatch, kind, iters):
    """On a CUDA tensor `_iterate` runs two steps, captures the third as a
    CUDA graph and replays it: the result equals the same solve run step by
    step on the card (graph off), and the CPU's."""
    from neuralpde_tpu_torch import gauss_newton as gn

    rng = np.random.default_rng(3)
    A = torch.tensor(rng.normal(size=(40, 12)), dtype=torch.float64)
    b = torch.tensor(rng.normal(size=40), dtype=torch.float64)
    assert iters > gn._EAGER_STEPS
    replayed = _inner_solve(kind, A.to(cuda), b.to(cuda), iters)
    cpu = _inner_solve(kind, A, b, iters)
    monkeypatch.setattr(gn, "_EAGER_STEPS", 10 ** 6)
    eager = _inner_solve(kind, A.to(cuda), b.to(cuda), iters)
    torch.testing.assert_close(replayed, eager, rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(replayed.cpu(), cpu, rtol=1e-10, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("solver,options", [
    ("lsqr", {}), ("lsqr", {"scalar_dtype": torch.float64}), ("cg", {}),
    ("cg", {"precondition": True})], ids=["lsqr", "lsqr_f64", "cg", "cg_jacobi"])
def test_lm_graph_replay_matches_eager(cuda, monkeypatch, solver, options):
    """Levenberg-Marquardt on a Taylor-mode residual (the tanh_jet2 kernels
    inside `torch.func.jvp`/`vjp`): the captured and replayed inner solve
    gives the same objective history and parameters as step by step."""
    from neuralpde_tpu_torch import DerivativeEngine, lm_least_squares, mlp
    from neuralpde_tpu_torch import gauss_newton as gn
    from neuralpde_tpu_torch.nn.core import TrialFunction

    g = torch.Generator().manual_seed(0)
    net = mlp([2, 8, 8, 1], dtype=torch.float32)
    net.reset_parameters(g)
    theta = {k: v.detach().to(cuda) for k, v in net.named_parameters()}
    x = torch.rand((2, 64), generator=g).to(cuda)
    engine = DerivativeEngine("jet")

    def r_fn(th):
        return engine(TrialFunction(net, th), x, [0, 0], 2).reshape(-1) + 1.0

    runs = []
    for eager_steps in (gn._EAGER_STEPS, 10 ** 6):
        monkeypatch.setattr(gn, "_EAGER_STEPS", eager_steps)
        before = tj.tanh_jet2_jvp_cuda.launches
        runs.append(lm_least_squares(r_fn, theta, maxiters=3, cg_iters=8,
                                     solver=solver, **options))
        assert tj.tanh_jet2_jvp_cuda.launches > before
    replayed, eager = runs
    assert replayed.history[-1] < replayed.history[0]
    np.testing.assert_allclose(replayed.history, eager.history, rtol=1e-6)
    for k in theta:
        torch.testing.assert_close(replayed.u[k], eager.u[k], rtol=1e-5,
                                   atol=1e-6)


def _dense_problem(cuda, strategy, adaloss=None):
    """bench's 2-D Poisson problem at a small size on the card, float32."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.accuracy import poisson_2d_system

    return npde.discretize(poisson_2d_system(), npde.PhysicsInformedNN(
        npde.mlp([2, 8, 8, 1]), strategy, derivative="jet",
        dtype=torch.float32, device=cuda, adaptive_loss=adaloss))


def _eager(prob, steps, seed):
    """``steps`` eager steps through `make_step` -> (losses, parameters,
    adaptive state)."""
    import neuralpde_tpu_torch as npde

    pinnrep = prob.pinnrep
    lf = pinnrep.loss_functions
    step = npde.make_step(prob.loss, npde.adam(1e-3), pinnrep.adaloss,
                          lf.pde_loss_functions, lf.bc_loss_functions)
    carry = step.init(prob.init_params, pinnrep.adaloss.init_state(
        len(lf.pde_loss_functions), len(lf.bc_loss_functions), torch.float32,
        pinnrep.device))
    generator = torch.Generator(device=pinnrep.device).manual_seed(seed)
    losses = []
    for _ in range(steps):
        carry, (loss, _) = step(carry, generator)
        losses.append(float(loss))
    return losses, {k: v.detach() for k, v in carry[0].items()}, carry[2]


@pytest.mark.cuda
def test_solve_replays_a_captured_step_equal_to_eager_steps(cuda):
    """`solve` on the card: one eager step, a capture, replays; the losses
    and parameters of eager `make_step` steps from the same generator seed
    (the stochastic points come from the generator inside the graph)."""
    import neuralpde_tpu_torch as npde

    prob = _dense_problem(cuda, npde.StochasticTraining(
        256, bcs_points=32, microbatch=64))
    losses, theta, _ = _eager(prob, 6, seed=3)
    before = tj.tanh_jet2_forward_cuda.launches
    res = npde.solve(prob, npde.adam(1e-3), maxiters=6, inner_steps=3,
                     generator=torch.Generator(device=cuda).manual_seed(3))
    assert tj.tanh_jet2_forward_cuda.launches > before
    assert res.aux["cuda_graph"]["captures"] == 1
    assert res.aux["cuda_graph"]["replays"] == 5
    np.testing.assert_allclose(res.history, [losses[2], losses[5]],
                               rtol=1e-6)
    for k, v in theta.items():
        torch.testing.assert_close(res.u[k], v, rtol=1e-6, atol=1e-7)


def test_replayed_launches_are_counted_apart_from_the_wrappers():
    """A graph runner reports each replay with the launches its capture
    counted (`counts_since`); the wrappers' own counts do not move."""
    tj.reset_launch_counts()
    tj.reset_replayed_counts()
    before = tj.launch_counts()
    tj.tanh_jet2_forward_cuda.launches += 2      # what a capture counts
    tj.tanh_jet2_backward_cuda.launches += 1
    captured = tj.counts_since(before)
    assert captured == {"tanh_jet2_forward": 2, "tanh_jet2_backward": 1,
                        "tanh_jet2_jvp": 0}
    tj.add_replayed(captured, 5)
    tj.add_replayed(captured)
    assert tj.replayed_counts() == {"tanh_jet2_forward": 12,
                                    "tanh_jet2_backward": 6,
                                    "tanh_jet2_jvp": 0}
    assert tj.launch_counts()["tanh_jet2_forward"] == 2
    tj.reset_launch_counts()
    assert tj.replayed_counts()["tanh_jet2_forward"] == 12
    tj.reset_replayed_counts()
    assert set(tj.replayed_counts().values()) == {0}


@pytest.mark.cuda
def test_solve_reports_each_replay_with_its_captured_launches(cuda):
    """`solve`'s graph runner: the eager step and the capture launch the
    step's kernels through the wrappers, each replay reports them again."""
    import neuralpde_tpu_torch as npde

    prob = _dense_problem(cuda, npde.GridTraining(0.1))
    tj.reset_launch_counts()
    tj.reset_replayed_counts()
    res = npde.solve(prob, npde.adam(1e-3), maxiters=8, inner_steps=4)
    eager, replayed = tj.launch_counts(), tj.replayed_counts()
    g = res.aux["cuda_graph"]
    assert g["captures"] == 1 and g["replays"] >= 1
    assert eager["tanh_jet2_forward"] > 0
    per_step = {k: n // 2 for k, n in eager.items()}   # eager step + capture
    assert replayed == {k: n * g["replays"] for k, n in per_step.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("u0,sizes", [(0.0, [3, 8, 1]),
                                      ((1.0, 0.5), [3, 8, 2])],
                         ids=["scalar", "vector"])
def test_pinoode_on_a_plain_chain_is_captured(cuda, u0, sizes):
    """`solve_pino_ode` with a plain chain replays its captured step (its
    IC residual copies nothing from the host inside the capture)."""
    import neuralpde_tpu_torch as npde

    def f(u, p, t):
        out = p[0] * torch.cos(p[1] * t)
        return out if sizes[-1] == 1 else [out, -u[0]]

    sol = npde.solve_pino_ode(
        npde.ODEProblem(f, np.asarray(u0), (0.0, 1.0)),
        npde.PINOODE(npde.mlp(sizes), npde.adam(1e-2),
                     bounds=[(1.0, 2.0), (2.0, 3.0)], number_of_parameters=8,
                     strategy=npde.StochasticTraining(16)),
        maxiters=6, inner_steps=3, device=cuda)
    g = sol.original.aux["cuda_graph"]
    assert g["captures"] == 1 and g["replays"] == 5    # steps 1-5
    assert np.isfinite(sol.original.objective)


@pytest.mark.cuda
def test_each_replay_draws_fresh_points(cuda):
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.ops.sampling import uniform_random
    from neuralpde_tpu_torch.train import GraphedSteps, _side_stream

    strategy = npde.StochasticTraining(128, bcs_points=16)
    drawn = torch.zeros((2, 4), device=cuda)

    def sampler(n, lb, ub, generator):
        pts = uniform_random(n, lb, ub, generator)
        if n == 128:
            drawn.copy_(pts[:, :4])
        return pts

    strategy.sampler = sampler
    prob = _dense_problem(cuda, strategy)
    step = npde.make_step(prob.loss, npde.adam(1e-3), prob.pinnrep.adaloss)
    carry = step.init(prob.init_params, prob.pinnrep.adaloss.init_state(
        1, 4, torch.float32, cuda))
    runner = GraphedSteps(step, carry,
                          torch.Generator(device=cuda).manual_seed(0))
    seen = []
    with _side_stream(drawn):
        for i in range(4):
            runner(i)
            seen.append(drawn.clone())
    torch.cuda.synchronize()
    assert runner.captures == 1 and runner.replays == 3
    for a, b in zip(seen[1:], seen[2:]):
        assert not torch.equal(a, b)


@pytest.mark.cuda
def test_reweighting_step_is_its_own_graph_on_schedule(cuda):
    """GradientScaleAdaptiveLoss every 3 steps: the plain and the
    reweighting step are captured apart, and the weights follow eager
    steps."""
    import neuralpde_tpu_torch as npde

    prob = _dense_problem(cuda, npde.GridTraining(0.1),
                          adaloss=npde.GradientScaleAdaptiveLoss(3))
    losses, theta, ada = _eager(prob, 12, seed=0)
    res = npde.solve(prob, npde.adam(1e-3), maxiters=12, inner_steps=4)
    assert res.aux["cuda_graph"]["captures"] == 2
    np.testing.assert_allclose(res.history, losses[3::4], rtol=1e-6)
    torch.testing.assert_close(res.aux["adaptive_state"]["bc_weights"],
                               ada["bc_weights"], rtol=1e-6, atol=0)
    assert not torch.equal(ada["bc_weights"], torch.ones_like(
        ada["bc_weights"]))
    for k, v in theta.items():
        torch.testing.assert_close(res.u[k], v, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_a_step_that_cannot_be_captured_raises(cuda):
    """torch.optim.Adam without ``capturable`` refuses capture: `solve`
    raises instead of running eagerly."""
    import neuralpde_tpu_torch as npde

    prob = _dense_problem(cuda, npde.GridTraining(0.25))
    with pytest.raises(RuntimeError, match="could not be captured"):
        npde.solve(prob, lambda ps: torch.optim.Adam(list(ps), lr=1e-3),
                   maxiters=3)


# float64 parameters of `solve` with `npde.lbfgs()`, card against CPU: the
# same arithmetic in other reduction orders (cuBLAS's and the CPU's), whose
# differences L-BFGS steps grow (chip_smoke.py's LBFGS_CARD_VS_CPU_RTOL)
LBFGS_CARD_VS_CPU_RTOL = 1e-8
# the optimizer state that `train.LBFGS` saved before its line search ran
# on the device, and still saves: a parameter's, then the first
# parameter's scalars and memory
LBFGS_STATE_KEYS = (
    {"params", "updates", "diff_params_memory", "diff_updates_memory"},
    {"count", "weights_memory", "learning_rate", "num_linesearch_steps",
     "decrease_error", "curvature_error"})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_zoom_step_kernel_is_bit_equal_to_the_transition(cuda, dtype):
    """The `zoom_step` kernel against `zoom_transition` on every step of
    real searches and on edge values (`transition_cases`), bit for bit:
    the state, the flag and, where a search ends, optax's info."""
    from neuralpde_tpu_torch.kernels import lbfgs_zoom as lz

    cases = lz.transition_cases(dtype, searches=100)
    assert len(cases) >= 1000
    n = len(cases)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    state = torch.tensor(np.stack([c[0] for c in cases]), device=cuda)
    value, slope = (torch.tensor(np.array([c[i] for c in cases], dtype=dtype),
                                 device=cuda) for i in (1, 2))
    flag = torch.zeros(n, dtype=torch.bool, device=cuda)
    info = [torch.full((n,), -1, dtype=d, device=cuda)
            for d in (tdt, torch.int64, tdt, tdt)]
    before = lz.zoom_step_cuda.launches
    for i in range(n):
        lz.zoom_step(state[i], value[i], slope[i], flag[i],
                     *(t[i] for t in info))
    torch.cuda.synchronize()
    assert lz.zoom_step_cuda.launches == before + n
    got = state.cpu().numpy()
    flags = flag.cpu().numpy()
    lr, steps, dec, curv = (t.cpu().numpy() for t in info)
    for i, case in enumerate(cases):
        want, nxt, searching = lz.zoom_transition(*case)
        assert got[i].tobytes() == want.tobytes(), (i, got[i], want)
        assert flags[i] == searching, i
        if searching:
            assert steps[i] == -1, i
        else:
            assert (lr[i].tobytes(), steps[i], dec[i].tobytes(),
                    curv[i].tobytes()) == (
                want[lz.STEPSIZE].tobytes(), int(want[lz.COUNT]),
                want[lz.DEC_ERR].tobytes(), want[lz.CURV_ERR].tobytes()), i


def _lbfgs_problem(device, dtype=torch.float64):
    """bench's 2-D Poisson problem on a grid, the L-BFGS stage's strategy."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.accuracy import poisson_2d_system

    torch.manual_seed(0)
    return npde.discretize(poisson_2d_system(), npde.PhysicsInformedNN(
        npde.mlp([2, 16, 16, 1], dtype=dtype), npde.GridTraining(1 / 15),
        derivative="jet", dtype=dtype, device=device))


@pytest.mark.cuda
def test_captured_lbfgs_solve_matches_the_cpu(cuda):
    """`solve(..., npde.lbfgs(), inner_steps=10)` in float64: the step runs
    once, is captured (its trials IF nodes) and replayed; the parameters
    match the CPU run's within LBFGS_CARD_VS_CPU_RTOL, with the same
    line-search steps a step."""
    import neuralpde_tpu_torch as npde

    card = _lbfgs_problem(cuda)
    cpu = _lbfgs_problem("cpu").with_params(
        {k: v.cpu() for k, v in card.init_params.items()})
    counts = {}
    for name, prob in (("card", card), ("cpu", cpu)):
        seen = []

        def record(it, loss, aux, seen=seen):
            seen.append(loss)

        res = npde.solve(prob, npde.lbfgs(), maxiters=20, inner_steps=10,
                         callback=record)
        counts[name] = (res, seen)
    res, _ = counts["card"]
    want, _ = counts["cpu"]
    assert res.aux["cuda_graph"]["captures"] == 1
    assert res.aux["cuda_graph"]["replays"] == 19
    for k, v in want.u.items():
        got = res.u[k].cpu()
        assert float((got - v).abs().max() / v.abs().max()) < (
            LBFGS_CARD_VS_CPU_RTOL), k
    assert res.history[-1] < res.history[0]


@pytest.mark.cuda
def test_captured_lbfgs_steps_count_searches_like_the_cpu(cuda):
    """Step by step through `GraphedSteps` (the first step eager, then
    replays) against the CPU's steps: equal line-search steps and
    stepsizes within LBFGS_CARD_VS_CPU_RTOL."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.train import GraphedSteps, _side_stream

    out = {}
    card = _lbfgs_problem(cuda)
    cpu = _lbfgs_problem("cpu").with_params(
        {k: v.cpu() for k, v in card.init_params.items()})
    for name, prob in (("card", card), ("cpu", cpu)):
        rep = prob.pinnrep
        lf = rep.loss_functions
        step = npde.make_step(prob.loss, npde.lbfgs(), rep.adaloss,
                              lf.pde_loss_functions, lf.bc_loss_functions)
        carry = step.init(prob.init_params, rep.adaloss.init_state(
            len(lf.pde_loss_functions), len(lf.bc_loss_functions), rep.dtype,
            rep.device))
        gen = torch.Generator(device=rep.device).manual_seed(0)
        opt = carry[1]
        runner = GraphedSteps(step, carry, gen) if name == "card" else None
        record = []
        with _side_stream(next(iter(carry[0].values()))):
            for i in range(8):
                if runner is not None:
                    runner(i)
                else:
                    carry, _ = step(carry, gen)
                st = opt.state[opt._params[0]]
                record.append((int(st["num_linesearch_steps"]),
                               float(st["learning_rate"])))
        out[name] = record
    assert [c for c, _ in out["card"]] == [c for c, _ in out["cpu"]]
    for (_, a), (_, b) in zip(out["card"], out["cpu"]):
        assert abs(a - b) <= LBFGS_CARD_VS_CPU_RTOL * abs(b)
    assert any(c > 1 for c, _ in out["cpu"])


@pytest.mark.cuda
def test_a_replayed_lbfgs_block_reads_nothing_on_the_host(cuda):
    """Replays of the captured L-BFGS step under
    `torch.cuda.set_sync_debug_mode("error")`: no host synchronisation."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.train import GraphedSteps, _side_stream

    prob = _lbfgs_problem(cuda, torch.float32)
    rep = prob.pinnrep
    lf = rep.loss_functions
    step = npde.make_step(prob.loss, npde.lbfgs(), rep.adaloss,
                          lf.pde_loss_functions, lf.bc_loss_functions)
    carry = step.init(prob.init_params, rep.adaloss.init_state(
        len(lf.pde_loss_functions), len(lf.bc_loss_functions), rep.dtype,
        rep.device))
    runner = GraphedSteps(step, carry,
                          torch.Generator(device=cuda).manual_seed(0))
    with _side_stream(next(iter(carry[0].values()))):
        runner(0)
        runner(1)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(2, 12):
                loss, _ = runner(i)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    stats = runner.stats()
    # step 1 is captured and replayed at once, steps 2-11 replay
    assert stats["captures"] == 1 and stats["replays"] == 11
    assert torch.isfinite(loss)


@pytest.mark.cuda
def test_lbfgs_checkpoint_of_the_saved_layout_restores_and_continues(
        cuda, tmp_path):
    """A checkpoint holds `LBFGS`'s state in its saved keys and dtypes (the
    line search's scratch is not saved); a run resumed from it continues
    as the straight run does (graph against eager steps: rtol 1e-6)."""
    import neuralpde_tpu_torch as npde

    prob = _lbfgs_problem(cuda)
    straight = npde.solve(prob, npde.lbfgs(), maxiters=12, inner_steps=3)
    first = npde.solve(prob, npde.lbfgs(), maxiters=6, inner_steps=3,
                       checkpoint_dir=str(tmp_path), checkpoint_every=6)
    with open(tmp_path / "meta.json") as f:
        layout = json.load(f)["opt_state"]["layout"]
    n = len(prob.init_params)
    assert set(layout) == (
        {f"0.{k}" for k in LBFGS_STATE_KEYS[1]}
        | {f"{i}.{k}" for i in range(n) for k in LBFGS_STATE_KEYS[0]})
    saved = np.load(tmp_path / "opt_state.npz")
    assert saved["0.count"].dtype == np.int64 and int(saved["0.count"]) == 6
    resumed = npde.solve(prob, npde.lbfgs(), maxiters=12, inner_steps=3,
                         checkpoint_dir=str(tmp_path))
    assert first.iterations == 6 and resumed.iterations == 12
    for k, v in straight.u.items():
        torch.testing.assert_close(resumed.u[k], v, rtol=1e-6, atol=1e-9)


@pytest.mark.cuda
def test_captured_lbfgs_ensemble_draws_as_its_eager_steps(cuda, monkeypatch):
    """`solve_ensemble` with `npde.lbfgs()` on `StochasticTraining`: each
    member's searches draw its points again from graph-safe generator
    states set before each replay; the captured run ends where the same
    steps run eagerly end (graph against eager steps: rtol 1e-6), and its
    generator advanced as theirs."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.parallel import ensemble
    from neuralpde_tpu_torch.train import GraphedSteps

    class Eager(GraphedSteps):
        def __call__(self, iteration):
            return self.step.run(self.theta, self.opt, self.ada_state,
                                 self.generator,
                                 self.step.reweights(iteration))

    prob = _dense_problem(cuda, npde.StochasticTraining(64))
    out = []
    for runner in (GraphedSteps, Eager):
        monkeypatch.setattr(ensemble, "GraphedSteps", runner)
        gen = torch.Generator(device=cuda).manual_seed(4)
        res = npde.solve_ensemble(prob, npde.lbfgs(), maxiters=6,
                                  inner_steps=3, n_ensemble=2, generator=gen)
        out.append((res, gen.get_offset()))
    (graphed, g_offset), (eager, e_offset) = out
    assert graphed.aux["cuda_graph"]["captures"] == 1
    assert graphed.aux["cuda_graph"]["replays"] == 5
    assert g_offset == e_offset
    for k, v in eager.members.items():
        torch.testing.assert_close(graphed.members[k], v, rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.cuda
def test_a_torch_lbfgs_factory_still_trains_on_the_card(cuda):
    """A user's `torch.optim.LBFGS` reads the host: its steps run eagerly
    and descend."""
    import neuralpde_tpu_torch as npde

    prob = _dense_problem(cuda, npde.GridTraining(0.1))
    res = npde.solve(prob, lambda ps: torch.optim.LBFGS(
        list(ps), max_iter=1, max_eval=21, line_search_fn="strong_wolfe"),
        maxiters=5)
    assert res.aux["cuda_graph"]["captures"] == 0
    assert res.history[-1] < res.history[0]


@pytest.mark.cuda
def test_port_adam_is_torch_adams_eager_arithmetic_on_the_card(cuda):
    """`Adam` (device-side step count) against torch.optim.Adam (host-side
    bias corrections), float32: equal to the last bit."""
    from neuralpde_tpu_torch.train import Adam

    g = torch.Generator(device=cuda).manual_seed(1)
    ps = [torch.randn(shape, generator=g, device=cuda).requires_grad_(True)
          for shape in ((64, 2), (64, 1), (1, 64))]
    qs = [p.detach().clone().requires_grad_(True) for p in ps]
    ref = torch.optim.Adam(ps, lr=2e-3, eps=1e-8, foreach=True)
    ours = Adam(qs, lr=2e-3)
    for _ in range(50):
        for p, q in zip(ps, qs):
            p.grad = 1e-3 * torch.randn(p.shape, generator=g, device=cuda)
            q.grad = p.grad.clone()
        ref.step()
        ours.step()
    for p, q in zip(ps, qs):
        assert torch.equal(p, q)


# --- integrals and the ODE solver surface on the card ---------------------------

def _oscillator_loss(cuda, strategy=None):
    """NNODE's objective for u1' = u2, u2' = -u1 on the card ->
    (loss, initial parameters)."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.solvers.ode import build_ode_loss

    prob = npde.ODEProblem(lambda u, p, t: [u[1], -u[0]],
                           np.array([1.0, 0.0]), (0.0, 1.0))
    alg = npde.NNODE(npde.mlp([1, 16, 2]), strategy=strategy)
    return build_ode_loss(prob, alg, dt=0.05, device=cuda)[:2]


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["grid", "quadrature", "stochastic"])
def test_captured_nnode_step_matches_eager_steps(cuda, strategy):
    """`solve_ode` trains a bare problem (no `PINNRepresentation`) through
    the captured graph: 8 steps equal 8 eager `make_step` steps from the
    same parameters and generator seed (rtol 1e-6)."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.solvers.ode import _SimpleProblem

    strategies = {"grid": None, "quadrature": npde.QuadratureTraining(),
                  "stochastic": npde.StochasticTraining(64)}
    loss, theta0 = _oscillator_loss(cuda, strategies[strategy])
    bare = _SimpleProblem(loss, theta0)
    step = npde.make_step(bare.loss, npde.adam(1e-2))
    ones = {k: torch.ones(n, device=cuda) for k, n in
            (("pde_weights", 0), ("bc_weights", 0), ("additional_weights", 1))}
    carry = step.init(theta0, ones)
    generator = torch.Generator(device=cuda).manual_seed(3)
    eager = []
    for _ in range(8):
        carry, (value, _) = step(carry, generator)
        eager.append(float(value))
    res = npde.solve(bare, npde.adam(1e-2), maxiters=8, inner_steps=4,
                     generator=torch.Generator(device=cuda).manual_seed(3))
    assert res.aux["cuda_graph"]["captures"] == 1
    assert res.aux["cuda_graph"]["replays"] == 7
    np.testing.assert_allclose(res.history, eager[3::4], rtol=1e-6)
    for k, v in carry[0].items():
        torch.testing.assert_close(res.u[k], v.detach(), rtol=1e-6, atol=1e-7)
    assert all(v.is_cuda for v in res.u.values())


@pytest.mark.cuda
def test_solve_ode_runs_on_the_card_by_default(cuda):
    import neuralpde_tpu_torch as npde

    prob = npde.ODEProblem(lambda u, p, t: -u, 1.0, (0.0, 1.0),
                           analytic=lambda u0, p, t: np.exp(-t))
    sol = npde.solve_ode(prob, npde.NNODE(npde.mlp([1, 12, 1]),
                                          npde.adam(0.05)),
                         dt=0.05, maxiters=600, abstol=1e-12, inner_steps=25)
    assert all(v.is_cuda for v in sol.original.u.values())
    assert sol.original.aux["cuda_graph"]["replays"] == 599
    assert sol.errors["l2"] < 0.05 and sol(0.5).is_cuda


@pytest.mark.cuda
def test_complex_nnode_trains_through_the_graph(cuda):
    """u' = i u with complex64 parameters: the step (complex matmuls and
    tanh, `Adam` on complex leaves) is captured and replayed."""
    import neuralpde_tpu_torch as npde

    prob = npde.ODEProblem(lambda u, p, t: 1j * u, np.complex64(1.0),
                           (0.0, 2.0))
    net = npde.mlp([1, 16, 1], dtype=torch.complex64)
    real = npde.mlp([1, 16, 1])
    real.reset_parameters(torch.Generator().manual_seed(0))
    init = {k: v.detach().to(torch.complex64)
            for k, v in real.named_parameters()}
    sol = npde.solve_ode(prob, npde.NNODE(net, npde.adam(0.02),
                                          init_params=init),
                         dt=0.05, maxiters=2000, abstol=1e-10, inner_steps=50)
    assert sol.original.aux["cuda_graph"]["replays"] == 1999
    ts = np.linspace(0, 2, 20, dtype=np.float32)
    assert np.abs(sol(ts).cpu().numpy() - np.exp(1j * ts)).max() < 0.1


@pytest.mark.cuda
def test_integral_rule_tensors_live_on_the_card(cuda):
    """An integro-differential loss reads its nodes and weights from the
    device (a capture would fail on a copy from the host), stays float32,
    and its captured steps follow eager ones."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.ops.quadrature import rule_tensors

    x = npde.symbols("x")
    u = npde.DepVar("u")
    eq = npde.Eq((npde.Differential(x) ** 2)(u(x))
                 + npde.Integral(x, 0.0, x)(u(x)),
                 1.0 - npde.cos(x) - npde.sin(x))
    bcs = [npde.Eq(u(0.0), 0.0), npde.Eq(npde.Differential(x)(u(0.0)), 1.0)]
    system = npde.PDESystem(eq, bcs, [npde.Domain(x, npde.Interval(0, np.pi))],
                            [x], [u(x)])
    prob = npde.discretize(system, npde.PhysicsInformedNN(
        npde.mlp([1, 16, 16, 1]), npde.StochasticTraining(256),
        derivative="jet", integral_order=12, dtype=torch.float32, device=cuda))
    nodes, weights = rule_tensors(1, 12, 1, torch.float32, cuda)
    assert nodes.is_cuda and weights.is_cuda
    assert rule_tensors(1, 12, 1, torch.float32, cuda)[0] is nodes
    losses, theta, _ = _eager(prob, 6, seed=0)
    before = tj.tanh_jet2.launches
    res = npde.solve(prob, npde.adam(1e-3), maxiters=6, inner_steps=3)
    assert tj.tanh_jet2.launches > before
    assert res.aux["cuda_graph"]["captures"] == 1
    assert res.aux["cuda_graph"]["replays"] == 5
    np.testing.assert_allclose(res.history, losses[2::3], rtol=1e-6)
    assert all(v.dtype == torch.float32 for v in res.u.values())


def _quad_adapt_problem(cuda):
    """A 1-D Poisson problem whose auto-refined rule fails its check on the
    trained solution, so that ``quad_adapt`` solves again."""
    import neuralpde_tpu_torch as npde

    x = npde.symbols("x")
    u = npde.DepVar("u")
    eq = npde.Eq((npde.Differential(x) ** 2)(u(x)),
                 -np.pi ** 2 * npde.sin(np.pi * x))
    system = npde.PDESystem(eq, [npde.Eq(u(0.0), 0.0), npde.Eq(u(1.0), 0.0)],
                            [npde.Domain(x, npde.Interval(0, 1))], [x], [u(x)])
    strategy = npde.QuadratureTraining(order=3, reltol=0.05, abstol=1e-8,
                                       maxiters=400)
    chain = npde.Chain(npde.FourierFeatures(1, 16, sigma=6.0),
                       npde.Dense(32, 24, torch.tanh), npde.Dense(24, 1))
    return npde.discretize(system, npde.PhysicsInformedNN(
        chain, strategy, derivative="jet", dtype=torch.float64, device=cuda))


@pytest.mark.cuda
def test_quad_adapt_resolves_with_fresh_graphs(cuda):
    """Each re-solve of ``quad_adapt`` captures its own graph; the counts
    add up over the rounds."""
    import warnings

    import neuralpde_tpu_torch as npde

    prob = _quad_adapt_problem(cuda)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = npde.solve(prob, npde.adam(1e-3), maxiters=300, inner_steps=50,
                         quad_adapt=True, quad_adapt_rounds=1)
    assert res.iterations == 600
    assert res.aux["cuda_graph"]["captures"] == 2
    assert res.aux["cuda_graph"]["replays"] == 598


@pytest.fixture
def spans_on():
    """Spans on for the test, the switch restored after it."""
    from neuralpde_tpu_torch.utils import profiling

    before = profiling.spans_enabled()
    profiling.enable_spans(True)
    yield
    profiling.enable_spans(before)


def _capture_spans_agree(spans, graphs) -> float:
    """The capture's children lie inside it; its seconds are the graph
    counter's; a replay a span.  Returns the children's share of the
    capture's seconds."""
    capture = spans["solve.capture"]
    children = [spans[f"solve.capture.{part}"]
                for part in ("enter", "record", "instantiate")]
    assert capture["count"] == graphs["captures"]
    for child in children:
        assert child["parent"] == "solve.capture"
        assert child["count"] == graphs["captures"]
    inside = sum(child["total_s"] for child in children)
    assert inside <= capture["total_s"]
    np.testing.assert_allclose(capture["self_s"], capture["total_s"] - inside,
                               rtol=1e-9, atol=1e-12)
    assert graphs["capture_seconds"] == capture["total_s"]
    assert spans["solve.replay"]["count"] == graphs["replays"]
    assert isinstance(capture["segments"], int) and capture["segments"] >= 0
    return inside / capture["total_s"]


@pytest.mark.cuda
def test_solve_spans_split_the_capture_and_count_the_replays(cuda, spans_on):
    """With spans on, `solve` on the card records one eager step, the
    capture with its entry, recorded step and instantiation, and a span a
    replay, from the clock of the graph counter's seconds."""
    import neuralpde_tpu_torch as npde

    prob = _dense_problem(cuda, npde.StochasticTraining(
        256, bcs_points=32, microbatch=64))
    res = npde.solve(prob, npde.adam(1e-3), maxiters=6, inner_steps=3,
                     generator=torch.Generator(device=cuda).manual_seed(3))
    spans, graphs = res.aux["spans"], res.aux["cuda_graph"]
    assert graphs["captures"] == 1 and graphs["replays"] == 5
    assert spans["solve.eager_step"]["count"] == 1
    assert spans["solve.read"]["count"] == 2
    assert _capture_spans_agree(spans, graphs) >= 0.99


@pytest.mark.cuda
def test_quad_adapt_adds_up_the_resolves_spans(cuda, spans_on):
    """Under ``quad_adapt`` the re-solve's spans join the first solve's, as
    its graph counts do.  (These captures take ~14 ms, of which the graph's
    preparation before `torch.cuda.graph`'s entry, the capture's own time,
    is ~2%.)"""
    import warnings

    import neuralpde_tpu_torch as npde

    prob = _quad_adapt_problem(cuda)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = npde.solve(prob, npde.adam(1e-3), maxiters=300, inner_steps=50,
                         quad_adapt=True, quad_adapt_rounds=1)
    spans = res.aux["spans"]
    assert spans["solve"]["count"] == 2
    assert spans["solve.read"]["count"] == 12
    _capture_spans_agree(spans, res.aux["cuda_graph"])


@pytest.mark.cuda
def test_capture_spans_are_profiler_ranges(cuda, spans_on):
    """Under `torch.profiler` the capture's spans are ranges of the trace,
    the children inside the capture."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import neuralpde_tpu_torch as npde

    prob = _dense_problem(cuda, npde.GridTraining(0.1))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        npde.solve(prob, npde.adam(1e-3), maxiters=4, inner_steps=2)
    events = {}
    for e in prof.events():
        # each range is a host event, and on the card also an annotation
        # of the device's timeline
        if e.name.startswith("solve") and e.device_type == DeviceType.CPU:
            events.setdefault(e.name, []).append(e.time_range)
    (capture,) = events["solve.capture"]
    for part in ("enter", "record", "instantiate"):
        (child,) = events[f"solve.capture.{part}"]
        assert capture.start <= child.start and child.end <= capture.end
    assert len(events["solve.replay"]) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("ibp,launched", [(0, True), (1, False)])
def test_captured_weak_step_matches_eager_steps(cuda, ibp, launched):
    """A `WeakTraining` step through `solve`: one eager step, a capture,
    replays, equal to eager `make_step` steps; grid, contraction tensors
    and row weights lie on the card, so the capture copies nothing from the
    host.  ibp = 0 keeps second derivatives on the net (Taylor mode, the
    kernel), ibp = 1 leaves first derivatives (no launch)."""
    import neuralpde_tpu_torch as npde

    prob = _dense_problem(cuda, npde.WeakTraining(elements=3, n_test=4,
                                                  ibp=ibp))
    losses, theta, _ = _eager(prob, 6, seed=3)
    before = tj.tanh_jet2_forward_cuda.launches
    res = npde.solve(prob, npde.adam(1e-3), maxiters=6, inner_steps=3)
    assert (tj.tanh_jet2_forward_cuda.launches > before) == launched
    assert res.aux["cuda_graph"]["captures"] == 1
    assert res.aux["cuda_graph"]["replays"] == 5
    np.testing.assert_allclose(res.history, [losses[2], losses[5]],
                               rtol=1e-6)
    for k, v in theta.items():
        torch.testing.assert_close(res.u[k], v, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_weak_adaptive_captures_one_graph_a_round(cuda):
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.accuracy import poisson_1d_system

    disc = npde.PhysicsInformedNN(
        npde.mlp([1, 8, 8, 1]), npde.WeakTraining(elements=4, n_test=4),
        dtype=torch.float32, device=cuda)
    ares = npde.solve_weak_adaptive(poisson_1d_system(), disc,
                                    npde.adam(1e-3), rounds=3, maxiters=6,
                                    inner_steps=3)
    assert [r.aux["cuda_graph"]["captures"] for r in ares.results] == [1] * 3
    assert [r.aux["cuda_graph"]["replays"] for r in ares.results] == [5] * 3
    assert ares.prob.pinnrep.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [None, [1, 2]], ids=["flat", "multilevel"])
def test_captured_fbpinn_step_matches_eager_steps(cuda, levels):
    """An FBPINN's Taylor-mode step through `solve` equals eager steps: the
    subdomain geometry is on the card before the capture, and the kernel
    takes the (J, hidden, N) tensors."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.accuracy import poisson_2d_system

    kw = dict(subdivisions=2) if levels is None else dict(levels=levels)
    net = npde.FBPINN([(0, 1)] * 2, hidden=(8,), **kw)
    prob = npde.discretize(poisson_2d_system(), npde.PhysicsInformedNN(
        net, npde.GridTraining(0.125), derivative="jet", dtype=torch.float32,
        device=cuda))
    assert any(device.type == "cuda" for _, device in net._geometry)
    losses, theta, _ = _eager(prob, 6, seed=0)
    before = tj.tanh_jet2_forward_cuda.launches
    res = npde.solve(prob, npde.adam(1e-3), maxiters=6, inner_steps=3)
    assert tj.tanh_jet2_forward_cuda.launches > before
    assert res.aux["cuda_graph"]["captures"] == 1
    assert res.aux["cuda_graph"]["replays"] == 5
    np.testing.assert_allclose(res.history, [losses[2], losses[5]],
                               rtol=1e-6)
    for k, v in theta.items():
        torch.testing.assert_close(res.u[k], v, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_gauss_newton_on_weak_rows_captures_its_inner_step(cuda):
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.accuracy import poisson_1d_system

    prob = npde.discretize(poisson_1d_system(), npde.PhysicsInformedNN(
        npde.mlp([1, 8, 8, 1]), npde.WeakTraining(elements=4, n_test=5),
        dtype=torch.float32, device=cuda))
    res = npde.solve_gauss_newton(prob, maxiters=3, cg_iters=20)
    assert res.aux["cuda_graph"] == {"captures": 3, "replays": 3 * 18}
    assert res.objective < res.history[0]


# --- the stochastic layer -------------------------------------------------------

def _gaussian_density(device):
    mu = torch.tensor([1.0, -2.0], device=device)
    sigma = torch.tensor([0.5, 2.0], device=device)
    return lambda q: -0.5 * torch.sum(((q - mu) / sigma) ** 2)


@pytest.mark.cuda
def test_captured_hmc_chain_is_bit_equal_to_the_eager_chain(cuda):
    """One draw eager, the next captured, the rest replayed, against every
    draw eager from the same generator seed."""
    from neuralpde_tpu_torch.bayesian import hmc

    runs = []
    for graphs in (True, False):
        g = torch.Generator(device=cuda).manual_seed(3)
        runs.append(hmc.sample(_gaussian_density(cuda),
                               torch.zeros(2, device=cuda), g, 40,
                               n_leapfrog=15, init_step_size=0.2,
                               graphs=graphs))
    a, b = runs
    assert a.aux["cuda_graph"]["captures"] == 1
    assert a.aux["cuda_graph"]["replays"] == 39
    assert b.aux["cuda_graph"]["captures"] == 0
    assert torch.equal(a.samples, b.samples)
    assert torch.equal(a.accept_prob, b.accept_prob)
    assert torch.equal(a.inv_mass, b.inv_mass)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["hmcda", "nuts"])
def test_captured_leapfrog_step_matches_eager(cuda, kernel):
    """"hmcda" and "nuts" replay a captured leapfrog step: their chains
    equal the eager ones drawn from the same seed."""
    from neuralpde_tpu_torch.bayesian import hmc

    runs = []
    for graphs in (True, False):
        g = torch.Generator(device=cuda).manual_seed(4)
        runs.append(hmc.sample(_gaussian_density(cuda),
                               torch.zeros(2, device=cuda), g, 30,
                               kernel=kernel, init_step_size=0.3,
                               max_depth=5, graphs=graphs))
    a, b = runs
    assert a.aux["cuda_graph"]["captures"] == 1
    assert a.aux["cuda_graph"]["replays"] > 30
    torch.testing.assert_close(a.samples, b.samples, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_captured_stochastic_sde_step_draws_fresh_points(cuda):
    """`StochasticTraining` SDE steps replay one captured graph that draws
    fresh t and z from the solve's generator: the losses of 8 steps equal
    those of 8 eager steps from the same seed."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.solvers.ode import _SimpleProblem
    from neuralpde_tpu_torch.solvers.sde import build_sde_loss

    prob = npde.SDEProblem(f=lambda u, p, t: -u, g=lambda u, p, t: 0.1,
                           u0=0.5, tspan=(0.0, 1.0))
    alg = npde.NNSDE(npde.mlp([3, 8, 1]), npde.adam(1e-2), sub_batch=4,
                     strategy=npde.StochasticTraining(16))
    total_loss, theta0, _, _ = build_sde_loss(prob, alg)
    res = npde.solve(_SimpleProblem(total_loss, theta0), npde.adam(1e-2),
                     maxiters=8, seed=2)
    assert res.aux["cuda_graph"]["replays"] == 7
    step = npde.make_step(_SimpleProblem(total_loss, theta0).loss,
                          npde.adam(1e-2))
    carry = step.init(theta0, {})
    g = torch.Generator(device=cuda).manual_seed(2)
    eager = []
    for _ in range(8):
        carry, (loss, _) = step(carry, g)
        eager.append(float(loss))
    np.testing.assert_allclose(res.history, eager, rtol=1e-5)
    fixed = torch.Generator(device=cuda)
    again = [float(total_loss(theta0, fixed.manual_seed(2)))
             for _ in range(2)]
    assert again[0] == again[1] and len(set(eager)) == 8


@pytest.mark.cuda
def test_bpinn_jet_gradient_matches_the_plain_version(cuda):
    """The BPINN log-density's gradient through `tanh_jet2` (kernel
    forward and backward) against the same density on the plain version
    (nested jvp, no kernel) at mlp([2,64,64,1]), float64."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.accuracy import poisson_2d_system
    from neuralpde_tpu_torch.bayesian.pde import PDELogTargetDensity

    out, init = {}, None
    for derivative in ("jet", "jvp"):
        disc = npde.BayesianPINN(npde.mlp([2, 64, 64, 1], dtype=torch.float64),
                                 npde.GridTraining(1 / 31),
                                 derivative=derivative, dtype=torch.float64,
                                 init_params=init)
        rep = npde.symbolic_discretize(poisson_2d_system(), disc)
        init = {k: v.clone() for k, v in rep.init_params.items()}
        ltd = PDELogTargetDensity(rep, None, npde.Normal(0.0, 2.0), [],
                                  ([0.05], [0.01] * 4, []), [0.05])
        q = ltd.init_flat_nn.clone().requires_grad_(True)
        before = dict(tj.launch_counts())
        v = ltd(q)
        (grad,) = torch.autograd.grad(v, q)
        torch.cuda.synchronize()
        counts = {k: n - before[k] for k, n in tj.launch_counts().items()}
        out[derivative] = (v.detach(), grad, counts)
    (vj, gj, cj), (vp, gp, cp) = out["jet"], out["jvp"]
    assert cj["tanh_jet2_forward"] > 0 and cj["tanh_jet2_backward"] > 0
    assert not any(cp.values())
    torch.testing.assert_close(vj, vp, rtol=1e-12, atol=0)
    torch.testing.assert_close(gj, gp, rtol=1e-10, atol=1e-10 * float(
        gp.abs().max()))


# --------------------------------------------------------- the operator layer

def _ns_operator(cuda, **kw):
    """The NS vorticity operator at the JAX test's downscaled size (FNO3D
    w8 m(4,4,3) d2, two GRF ICs on a 9 x 9 x 5 grid), float32, built on
    the card: ``(bare problem, build)``."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch import accuracy
    from neuralpde_tpu_torch.solvers import pino_pde
    from neuralpde_tpu_torch.solvers.ode import _SimpleProblem

    system, w0 = accuracy.ns_vorticity_system()
    alg = npde.PINOPDE(
        chain=npde.FNO3D(1, width=8, modes=(4, 4, 3), depth=2,
                         out_channels=2),
        number_of_parameters=2,
        input_functions={w0: kw.pop("sampler", accuracy.zero_mean_grf())},
        additional_loss=accuracy.ns_gauge,
        strategy=npde.GridTraining([1 / 8, 1 / 8, 0.5 / 4]), **kw)
    with _float32():
        b = pino_pde._build(system, alg, cuda)
    return _SimpleProblem(b.total_loss, b.theta0), b


class _float32:
    def __enter__(self):
        self.before = torch.get_default_dtype()
        torch.set_default_dtype(torch.float32)

    def __exit__(self, *exc):
        torch.set_default_dtype(self.before)


def _no_weights(cuda):
    return {k: torch.ones(n, device=cuda) for k, n in
            (("pde_weights", 0), ("bc_weights", 0), ("additional_weights", 1))}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 16, 15, 10, 2), (2, 15, 16, 9, 2)],
                         ids=["even", "odd"])
def test_spectral_conv3d_on_the_card_matches_the_cpu(cuda, shape):
    """The mixed spectra are not Hermitian (random weights); the inverse
    transform's fixed order gives the CPU's result on the card."""
    import neuralpde_tpu_torch as npde

    gen = torch.Generator().manual_seed(0)
    layer = npde.SpectralConv3D(shape[0], 3, (6, 6, 64))
    layer.reset_parameters(gen)
    x = torch.randn(shape, generator=gen)
    want = layer(x)
    got = layer.to(cuda)(x.to(cuda))
    torch.testing.assert_close(got.cpu(), want.detach(), rtol=1e-5,
                               atol=1e-6 * float(want.detach().abs().max()))


@pytest.mark.cuda
def test_captured_pinopde_step_matches_eager_steps(cuda):
    """The NS operator's step through `solve` (one eager step, a capture,
    replays: cuFFT inside the graph) equals eager `make_step` steps from the
    same parameters (rtol 1e-6)."""
    import neuralpde_tpu_torch as npde

    bare, b = _ns_operator(cuda)
    step = npde.make_step(bare.loss, npde.adam(2e-3))
    carry = step.init(b.theta0, _no_weights(cuda))
    generator = torch.Generator(device=cuda).manual_seed(0)
    eager = []
    for _ in range(6):
        carry, (value, _) = step(carry, generator)
        eager.append(float(value))
    res = npde.solve(bare, npde.adam(2e-3), maxiters=6, inner_steps=3)
    assert res.aux["cuda_graph"]["captures"] == 1
    assert res.aux["cuda_graph"]["replays"] == 5
    np.testing.assert_allclose(res.history, [eager[2], eager[5]], rtol=1e-6)
    for k, v in carry[0].items():
        torch.testing.assert_close(res.u[k], v.detach(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.cuda
def test_resampled_family_is_drawn_anew_in_every_replay(cuda):
    """``resample=True``: the GRF family is drawn inside the captured step
    from the solve's registered generator, so every replay trains on
    another family."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch import accuracy

    grf = accuracy.zero_mean_grf()
    drawn = torch.zeros(9, 9, device=cuda)

    def sampler(generator, grids, n):
        f = grf(generator, grids, n)
        if generator.device.type == "cuda":
            drawn.copy_(f[..., 0])
        return f

    bare, _ = _ns_operator(cuda, sampler=sampler, resample=True)
    seen = []
    res = npde.solve(bare, npde.adam(2e-3), maxiters=5, inner_steps=1,
                     callback=lambda it, loss, aux: seen.append(
                         drawn.clone()))
    assert res.aux["cuda_graph"]["captures"] == 1
    assert res.aux["cuda_graph"]["replays"] == 4
    for a, c in zip(seen[1:], seen[2:]):
        assert not torch.equal(a, c)


@pytest.mark.cuda
def test_captured_ensemble_round_matches_eager_rounds(cuda):
    """`solve_ensemble` on the card (the members' step captured as one
    graph) against the same `EnsembleStep` run eagerly (rtol 1e-6)."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.accuracy import poisson_2d_system
    from neuralpde_tpu_torch.parallel.ensemble import EnsembleStep

    prob = npde.discretize(poisson_2d_system(), npde.PhysicsInformedNN(
        npde.mlp([2, 8, 8, 1]), npde.GridTraining(0.1), dtype=torch.float32,
        device=cuda))
    gen = torch.Generator().manual_seed(0)
    inits = []
    for _ in range(3):
        prob.pinnrep.phi.module.reset_parameters(gen)
        inits.append({f"depvar.{k}": v.detach().to(cuda, copy=True) for k, v
                      in prob.pinnrep.phi.module.named_parameters()})
    members = iter(inits)
    res = npde.solve_ensemble(prob, npde.adam(1e-2), maxiters=6,
                              n_ensemble=3, inner_steps=3,
                              member_init=lambda g: next(members))
    assert res.aux["cuda_graph"]["captures"] == 1
    assert res.aux["cuda_graph"]["replays"] == 5
    step = EnsembleStep(prob.loss, npde.adam(1e-2), 3)
    carry = step.init({k: torch.stack([p[k] for p in inits])
                       for k in inits[0]},
                      {"pde_weights": torch.ones(3, 1, device=cuda),
                       "bc_weights": torch.ones(3, 4, device=cuda),
                       "additional_weights": torch.ones(3, 1, device=cuda)})
    for _ in range(6):
        carry, (losses, _) = step(carry, None)
    torch.testing.assert_close(res.losses, losses, rtol=1e-6, atol=0)
    for k, v in carry[0].items():
        torch.testing.assert_close(res.members[k], v.detach(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.cuda
def test_solve_returns_the_memory_of_its_graph(cuda):
    """After `solve` returns, the allocated bytes come back to within a
    few MiB of the bytes before it (the result's parameters), and a second
    solve of the same problem has the same peak as the first.  Every solve
    runs on the device's one side stream, whose cuBLAS workspaces (which
    PyTorch keeps per stream, 64 MiB on Hopper) the first solve of the
    process makes; a stream a solve left 64 MiB allocated after each."""
    import neuralpde_tpu_torch as npde

    prob = _dense_problem(cuda, npde.StochasticTraining(
        65_536, bcs_points=8_192, microbatch=8_192))
    npde.solve(prob, npde.adam(1e-3), maxiters=2, inner_steps=2)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    peaks = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        res = npde.solve(prob, npde.adam(1e-3), maxiters=6, inner_steps=3)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        assert torch.cuda.memory_allocated() - before < 4 * 2**20
        del res
    assert peaks[0] - before > 2**20             # the step's activations
    assert abs(peaks[1] - peaks[0]) < 2**20, peaks


@pytest.mark.cuda
def test_bench_spinn_rate_and_the_matmul_probe_run_on_the_card(cuda):
    """`bench_torch.spinn_points_per_sec` through `solve`'s graph on a
    1024^2 grid and its FLOPs a point, and the probe's float32 chain at
    1024^3 (TF32 off, so under the card's 67 TFLOP/s float32 peak)."""
    import bench_torch

    pps = bench_torch.spinn_points_per_sec(n=1024, steps=3)
    assert np.isfinite(pps) and pps > 0
    assert bench_torch.spinn_flops_per_point(n=1024) > 0
    probe = bench_torch._probe()
    tflops, seconds = probe.chain_tflops(1024, 1024, 1024, "float32", reps=20)
    assert 0 < tflops < probe.PEAK_TFLOPS["float32"] and seconds > 0
    assert not torch.backends.cuda.matmul.allow_tf32
