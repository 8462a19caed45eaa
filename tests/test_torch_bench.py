"""`bench_torch.py`, the port's `bench.py`, on the CPU.

The default line's keys against those `bench.py` prints (parsed from its
source), its values finite at a toy size; each problem builder against
the JAX package built as `bench.py` builds it (loss and gradient of each
equation from the same parameters and points, 1e-10 relative in float64);
the CPU baseline's median window; the FLOP count of a step against the
analytic GEMM count; the entry points' default device.
"""

import ast
import inspect
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import (
    hard, mlp_params, poisson_2d, poisson_2d_hard, rel_err, tree_like,
)
from neuralpde_tpu.ops import sampling as jsampling
from neuralpde_tpu_torch import accuracy

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64
TOY = dict(hidden=8, batch=64, microbatch=32,
           widths=((128, 64, None), (256, 64, None)), spinn_n=16,
           spinn_rank=8, steps=2, flops_batch=64, baseline_batch=64,
           ceiling_size=64, device="cpu")


def _bench_keys() -> set:
    """The keys of `bench.py`'s default line: ``main``'s ``fields`` (with
    the keys its ``**tf_fields``/``**_mfu_fields`` calls add) and those
    ``accuracy_suite`` writes into ``out``."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    funcs = {n.name: n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef)}

    def suffixes(fn):          # {prefix + "tflops": ..., ...}
        return {k.right.value for node in ast.walk(fn)
                if isinstance(node, ast.Return)
                and isinstance(node.value, ast.Dict)
                for k in node.value.keys}

    fields = next(node.value for node in ast.walk(funcs["main"])
                  if isinstance(node, ast.Assign)
                  and getattr(node.targets[0], "id", None) == "fields")
    keys = set()
    for key, value in zip(fields.keys, fields.values):
        if key is not None:
            keys.add(key.value)
            continue
        prefix = next((a.value for a in value.args
                       if isinstance(a, ast.Constant)
                       and isinstance(a.value, str)), "")
        keys |= {prefix + s for s in suffixes(funcs[value.func.id])}
    keys |= {node.slice.value for node in ast.walk(funcs["accuracy_suite"])
             if isinstance(node, ast.Subscript)
             and isinstance(node.ctx, ast.Store)
             and getattr(node.value, "id", None) == "out"}
    return keys


def test_default_line_has_benchs_keys_with_finite_values(monkeypatch):
    want = {bench_torch.RENAMED.get(k, k) for k in _bench_keys()}
    assert {"value", "w256_mfu_pct", "gn_rel_l2", "dense_tf32_speedup"} <= want
    assert set(bench_torch.THROUGHPUT_KEYS) <= want
    monkeypatch.setattr(bench_torch, "BASELINE_WINDOW_S", 0.0)
    throughput = bench_torch.throughput_fields(**TOY)
    assert set(throughput) == (set(bench_torch.THROUGHPUT_KEYS)
                               | set(bench_torch.ADDED))
    line = {**throughput,
            **bench_torch.accuracy_suite(poisson_steps=2, gn_iters=1,
                                         gn_cg_iters=2, ac_rank=4,
                                         ac_nodes=8, ac_iters=2,
                                         device="cpu")}
    assert set(line) == want | set(bench_torch.ADDED)
    assert line["metric"] == "2d_poisson_collocation_points_per_sec"
    assert line["device"] == bench_torch.cpu_model()
    assert line["power_limit_w"] is None          # no card
    for key, value in line.items():
        if key in ("metric", "unit", "device", "power_limit_w"):
            continue
        assert math.isfinite(value), key
        if not key.endswith("rel_l2"):
            assert value > 0, key


def _jax_dense(system, strategy, tree):
    return jpkg.discretize(system, jpkg.PhysicsInformedNN(
        jpkg.mlp([2, 8, 8, 1]), strategy, init_params=tree, derivative="jet",
        dtype=jnp.float64))


def _burgers(pkg):
    """bench.py's Burgers system (`burgers_points_per_sec`)."""
    x, t = pkg.symbols("x t")
    u = pkg.DepVar("u")
    eq = pkg.Eq(pkg.Differential(t)(u(x, t))
                + u(x, t) * pkg.Differential(x)(u(x, t)),
                0.05 * (pkg.Differential(x) ** 2)(u(x, t)))
    bcs = [pkg.Eq(u(x, 0.0), -pkg.sin(np.pi * x)),
           pkg.Eq(u(-1.0, t), 0.0), pkg.Eq(u(1.0, t), 0.0)]
    return pkg.PDESystem(eq, bcs, [pkg.Domain(x, pkg.Interval(-1, 1)),
                                   pkg.Domain(t, pkg.Interval(0, 1))],
                         [x, t], [u(x, t)])


def _builders(name, tree):
    """(JAX problem, port problem) of one builder at batch 64, microbatch
    32, mlp([2, 8, 8, 1]), float64."""
    init = tpkg.params_from_jax(tree)
    strategy = jpkg.StochasticTraining(64, bcs_points=8, microbatch=32)
    if name == "poisson":
        return (_jax_dense(poisson_2d(jpkg), strategy, tree),
                bench_torch.poisson_problem(64, 8, microbatch=32, dtype=F64,
                                            device="cpu", init_params=init))
    return (_jax_dense(_burgers(jpkg), strategy, tree),
            bench_torch.burgers_problem(64, 8, microbatch=32, dtype=F64,
                                        device="cpu", init_params=init))


def _fns(prob):
    lf = prob.pinnrep.loss_functions
    return lf.pde_loss_functions + lf.bc_loss_functions


@pytest.mark.parametrize("name, i", [("poisson", i) for i in range(5)]
                         + [("burgers", i) for i in range(4)])
def test_dense_builders_match_jax(name, i):
    """Equation i (the PDE, then each boundary condition): the JAX package's
    points for it fed to the port through the strategy's sampler."""
    tree = mlp_params(np.random.default_rng(3), [2, 8, 8, 1])
    jprob, tprob = _builders(name, tree)
    rep = jprob.pinnrep
    key = jax.random.key(20 + i)
    n = rep.strategy.points if i == 0 else rep.strategy.bcs_points
    lb, ub = jpkg.get_bounds(rep.domains, [(rep.pde_args + rep.bc_args)[i]],
                             rep.strategy.points, jnp.float64)[0]
    points = np.asarray(jsampling.uniform_random(key, n, lb, ub,
                                                 dtype=jnp.float64))

    def sampler(m, got_lb, got_ub, generator):
        assert m == n
        np.testing.assert_array_equal(got_lb.numpy(), lb)
        np.testing.assert_array_equal(got_ub.numpy(), ub)
        return torch.tensor(points)

    tprob.pinnrep.strategy.sampler = sampler
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda th: _fns(jprob)[i](th, key)))(jprob.init_params)
    want_grad = tpkg.params_from_jax(jax.tree.map(np.asarray, jgrad))
    theta = {k: v.clone().requires_grad_(True)
             for k, v in tprob.init_params.items()}
    got = _fns(tprob)[i](theta, torch.Generator())
    grads = torch.autograd.grad(got, list(theta.values()),
                                materialize_grads=True)
    assert rel_err(float(got.detach()), float(want)) < 1e-10
    for k, g in zip(theta, grads):
        assert rel_err(g.numpy(), want_grad[k].numpy()) < 1e-10, k


def test_spinn_builder_matches_jax():
    """bench.py's SPINN problem (hidden 8, rank 4, 16^2 grid): loss and
    gradient."""
    jnet = jpkg.SeparableNet([jpkg.Transformed(jpkg.mlp([1, 8, 8, 4]), hard)
                              for _ in range(2)])
    tree = tree_like(jnet.init(jax.random.key(0)), np.random.default_rng(4))
    jprob = jpkg.discretize(poisson_2d_hard(jpkg), jpkg.PhysicsInformedNN(
        jnet, jpkg.SeparableTraining(dx=1.0 / 15), init_params=tree,
        dtype=jnp.float64))
    ada = jprob.pinnrep.adaloss.init_state(1, 0, jnp.float64)
    want, jgrad = jax.jit(jax.value_and_grad(lambda th: jprob.loss(
        th, {"key": jax.random.key(0), "adaptive": ada})[0]))(
            jprob.init_params)
    want_grad = tpkg.params_from_jax(jax.tree.map(np.asarray, jgrad))

    tprob, _ = accuracy.poisson_spinn(
        16, 8, 4, dtype=F64, device="cpu",
        init_params=tpkg.params_from_jax(tree))
    theta = {k: v.clone().requires_grad_(True)
             for k, v in tprob.init_params.items()}
    got, _ = tprob.loss(theta, {"generator": None, "adaptive":
                                tprob.pinnrep.adaloss.init_state(
                                    1, 0, F64, "cpu")})
    got.backward()
    assert rel_err(float(got.detach()), float(want)) < 1e-10
    for k, v in theta.items():
        assert rel_err(v.grad.numpy(), want_grad[k].numpy()) < 1e-10, k


def _gemm_flops(sizes, batch):
    """GEMM FLOPs (2 m n k a product) of one jet step of bench's dense
    Poisson problem on ``mlp(sizes)``: one Taylor pass for u_xx and u_yy,
    the primal and each direction's two coefficients (five products)
    through every layer at ``batch`` points; in the backward each
    product's weight gradient and, past the first layer, its input
    gradient, where at the last layer only each direction's second
    coefficient reaches the loss; four boundary conditions of
    ``batch // 8`` points, a plain forward and its backward."""
    def layers(n):
        return [2 * i * o * n for i, o in zip(sizes[:-1], sizes[1:])]

    first, *mid, last = layers(batch)
    pde = (5 * (first + sum(mid) + last)
           + 5 * first + 5 * 2 * sum(mid) + 2 * 2 * last)
    first, *mid, last = layers(batch // 8)
    bcs = 4 * ((first + sum(mid) + last) + first + 2 * sum(mid) + 2 * last)
    return pde + bcs


def test_baseline_is_the_median_window_on_one_thread(monkeypatch, capsys):
    """One step a window (a window of 0 s), a warm-up and three timed
    windows: the rate is the median of the three printed, and the thread
    count is restored."""
    monkeypatch.setattr(bench_torch, "BASELINE_WINDOW_S", 0.0)
    monkeypatch.setattr(bench_torch, "BASELINE_WINDOWS", 3)
    threads = torch.get_num_threads()
    pps = bench_torch.measure_cpu_baseline(64)
    assert torch.get_num_threads() == threads
    err = capsys.readouterr().err
    windows = ast.literal_eval(err.split("windows ")[1].split(" (warm-up")[0])
    assert len(windows) == 3 and pps == sorted(windows)[1] > 0


def test_flop_count_equals_the_analytic_gemm_count():
    per_point = bench_torch.flops_per_point(8, 64, device="cpu")
    assert per_point * (64 + 4 * 8) == _gemm_flops([2, 8, 8, 1], 64)


@pytest.mark.parametrize("fn", [
    bench_torch.poisson_problem, bench_torch.burgers_problem,
    bench_torch.poisson_pps, bench_torch.flops_per_point,
    bench_torch.spinn_points_per_sec, bench_torch.spinn_flops_per_point,
    bench_torch.burgers_points_per_sec,
    bench_torch.throughput_fields, bench_torch.accuracy_suite,
    bench_torch.card_fields], ids=lambda f: f.__name__)
def test_default_device_is_the_card_and_raises_without_one(fn):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    kw = {"batch": 64} if "batch" in inspect.signature(fn).parameters else {}
    if fn is bench_torch.flops_per_point:
        kw["hidden"] = 8
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        fn(**kw)


def test_probe_needs_a_card_and_counts_a_chain():
    probe = bench_torch._probe()
    assert [c[0] for c in probe.configs()][:2] == ["f32_4096", "tf32_4096"]
    tflops, seconds = probe.chain_tflops(32, 32, 48, reps=3, device="cpu")
    assert tflops > 0 and seconds > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            probe.chain_tflops(32, 32, 32)
        with pytest.raises(SystemExit):
            probe.main()
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            bench_torch.main([])
