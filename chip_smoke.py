#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`neuralpde_tpu_torch`) on one CUDA card.

Run from the root of a checkout:

    python3 chip_smoke.py

It drives the port's main paths: the dense 2-D Poisson trainer of
`bench.py`'s headline (mlp([2, 64, 64, 1]), Taylor-mode derivatives,
stochastic batch of 2,097,152 points in microbatches of 32,768, Adam), the
separable (SPINN) trainer of `bench.py`'s second throughput line and its
accuracy recipes, and matrix-free Gauss-Newton, in phases that each print
their own lines, their seconds, and raise on failure:

1. device: the card's name, and nvidia-smi's name and power limit;
2. build: the kernel library from `neuralpde_tpu_torch/csrc/` with nvcc;
3. kernel vs plain: each kernel (tanh_jet2 forward, backward, jvp) against
   its plain PyTorch version at the shape each path below gives it, in
   float32 and float64, and both times at the dense path's shape;
4. card vs CPU: one loss and gradient of the dense bench problem at batch
   32,768, same parameters and points, on the card and the CPU (plain);
5. dense main path: one warm-up step and 20 timed steps through
   `make_step`, then two steps traced by `torch.profiler`;
6. transforms: `torch.func.jvp` and `torch.func.vjp` in the parameters of
   a Taylor-mode residual, against the nested-jvp engine, on the card;
7. separable card vs CPU: loss and gradient norm of bench's SPINN problem
   on a 128^2 grid;
8. separable main path: bench's `spinn_points_per_sec` configuration
   (16384^2 grid, rank 64) for 20 timed steps, then a profile;
9. separable accuracy: 500 Adam steps on a 128^2 grid, rel L2, for five
   seeds;
10. Gauss-Newton: LSQR with float64 scalars on a float32 separable problem,
    rel L2;
11. causal separable: one Allen-Cahn stage of 1000 Adam steps.

Then one JSON line of kernels (launches summed over the paths of phases 5,
6, 8, 9 and 11; phase 10 replays a captured CUDA graph, whose launches no
counter sees, and prints its own counts apart), and the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HIDDEN = 64
BATCH = 2_097_152          # bench.py's BATCH
MICROBATCH = 32_768        # bench.py's MICROBATCH
STEPS = 20
CHECK_BATCH = 32_768
CHECK_MICROBATCH = 8_192
KERNEL_SHAPE = (HIDDEN, MICROBATCH)   # the dense path's; timed
CHECK_SHAPES = (KERNEL_SHAPE,
                (HIDDEN, 16_384),    # separable main path (phase 8)
                (24, 33),            # Gauss-Newton (phase 10)
                (HIDDEN, 256))       # Allen-Cahn stage (phase 11)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.float64: dict(rtol=1e-12, atol=1e-12)}
CARD_VS_CPU_RTOL = {"loss": 1e-5, "grad_norm": 1e-4}
TRANSFORM_RTOL = 1e-4
SPINN_N = 16_384            # bench.py spinn_points_per_sec
SPINN_RANK = 64
SPINN_STEPS = 20
SPINN_CHECK_N = 128         # accuracy_suite's 128^2 grid
SPINN_SEEDS = (0, 1, 2, 3, 4)
# float32 rel L2 over these seeds: median 1.54e-3, worst 3.96e-3 (seed 0;
# 1.59e-3 in float64) on an H100; JAX's record 1.44e-3
SPINN_REL_L2_LIMIT = {"median": 2e-3, "max": 5e-3}
GN_MAXITERS = 200           # accuracy_suite's Gauss-Newton budget
GN_CG_ITERS = 200
JAX_RECORD = {"poisson_spinn_rel_l2": 1.44e-3, "gn_rel_l2": 2.80e-5,
              "allen_cahn_rel_l2": 0.0457}   # BENCH_r05.json, TPU v5e


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{name}; {torch.cuda.device_count()} device(s)")
    print(smi)
    return name, smi


def phase_build() -> None:
    from neuralpde_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    diagnostics = _build.build_library(force=True)
    seconds = time.perf_counter() - t0
    _build.load_library()
    sources = [p.name for p in sorted(_build.CSRC_DIR.glob("*.cu"))]
    print(f"[build] {_build.LIBRARY.name} from {sources} for sm_90a in "
          f"{seconds:.2f} s")
    for line in diagnostics.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")


def _event_ms(fn, iters: int = 50) -> float:
    """Time of one call of ``fn`` between CUDA events over ``iters`` calls
    after a warm-up call: device time plus any gap the host's launch
    overhead leaves between calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_us(prof) -> float:
    """Sum of the device kernels' own times in a profiler trace, in us."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def _device_ms(fn, iters: int = 50) -> float:
    """Device time of one call of ``fn``: its kernels' own times from
    `torch.profiler` over ``iters`` calls after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return _kernel_us(prof) / 1e3 / iters


def _in_turns(timer, plain, kernel) -> tuple[float, float]:
    """Time plain, kernel, kernel, plain; the mean of each pair."""
    p1, k1, k2, p2 = (timer(f) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_kernels(card: str) -> list[dict]:
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dtype in (torch.float32, torch.float64):
        for shape in CHECK_SHAPES:
            z, z1, z2, ga, ga1, ga2 = (
                2 * torch.randn(shape, generator=g, dtype=dtype,
                                device="cuda") for _ in range(6))
            cases = {
                "tanh_jet2_forward": (
                    lambda: tj.tanh_jet2_forward_cuda(z, z1, z2),
                    lambda: tj.tanh_jet2_reference(z, z1, z2)),
                "tanh_jet2_backward": (
                    lambda: tj.tanh_jet2_backward_cuda(z, z1, z2, ga, ga1,
                                                       ga2),
                    lambda: tj.tanh_jet2_backward_reference(z, z1, z2, ga,
                                                            ga1, ga2)),
                "tanh_jet2_jvp": (
                    lambda: tj.tanh_jet2_jvp_cuda(z, z1, z2, ga, ga1, ga2),
                    lambda: tj.tanh_jet2_jvp_reference(z, z1, z2, ga, ga1,
                                                       ga2)),
            }
            for name, (kernel, plain) in cases.items():
                got = kernel()
                torch.cuda.synchronize()
                want = plain()
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    torch.testing.assert_close(a, b, **TOL[dtype])
                err = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
                r = results.setdefault(name, dict(max_abs_err=0.0))
                r["max_abs_err"] = max(r["max_abs_err"], err)
                line = (f"[kernel] {name} {str(dtype)[6:]} {shape}: "
                        f"max_abs_err {err:.3e} (tolerance {TOL[dtype]})")
                if shape == KERNEL_SHAPE:
                    ms, plain_ms = _in_turns(_device_ms, plain, kernel)
                    call_ms, plain_call_ms = _in_turns(_event_ms, plain,
                                                       kernel)
                    line += (f"; device time kernel {ms:.4f} ms, plain "
                             f"{plain_ms:.4f} ms; per call with launch "
                             f"kernel {call_ms:.4f} ms, plain "
                             f"{plain_call_ms:.4f} ms; {card}")
                    if dtype == torch.float32:
                        r.update(ms=ms, plain_ms=plain_ms)
                print(line)
    return [dict(name=name, route="cuda",
                 source="neuralpde_tpu_torch/csrc/tanh_jet.cu",
                 replaces="neuralpde_tpu/ops/derivatives.py:84", **r)
            for name, r in results.items()]


def bench_problem(batch: int, microbatch: int, device, *, init_params=None,
                  sampler=None, matmul_precision=None):
    """`bench.py`'s 2-D Poisson training problem, in the port."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch import (
        DepVar, Differential, Domain, Eq, Interval, PDESystem,
        PhysicsInformedNN, StochasticTraining, discretize, mlp, symbols,
    )

    x, y = symbols("x y")
    u = DepVar("u")
    Dxx = Differential(x) ** 2
    Dyy = Differential(y) ** 2
    eq = Eq(Dxx(u(x, y)) + Dyy(u(x, y)),
            -npde.sin(np.pi * x) * npde.sin(np.pi * y))
    bcs = [Eq(u(0.0, y), 0.0), Eq(u(1.0, y), 0.0),
           Eq(u(x, 0.0), 0.0), Eq(u(x, 1.0), 0.0)]
    system = PDESystem(eq, bcs,
                       [Domain(x, Interval(0, 1)), Domain(y, Interval(0, 1))],
                       [x, y], [u(x, y)])
    strategy = StochasticTraining(batch, bcs_points=batch // 8,
                                  microbatch=microbatch)
    if sampler is not None:
        strategy.sampler = sampler
    disc = PhysicsInformedNN(mlp([2, HIDDEN, HIDDEN, 1]), strategy,
                             derivative="jet", dtype=torch.float32,
                             device=device, init_params=init_params,
                             matmul_precision=matmul_precision)
    return discretize(system, disc)


def _loss_and_grad_norm(prob) -> tuple[float, float]:
    from neuralpde_tpu_torch import matmul_precision

    pinnrep = prob.pinnrep
    theta = {k: v.clone().requires_grad_(True)
             for k, v in prob.init_params.items()}
    lf = pinnrep.loss_functions
    ada = pinnrep.adaloss.init_state(len(lf.pde_loss_functions),
                                     len(lf.bc_loss_functions), pinnrep.dtype,
                                     pinnrep.device)
    with matmul_precision(pinnrep.matmul_precision):
        loss, _ = prob.loss(theta, {"generator": None, "adaptive": ada})
        loss.backward()
    norm = math.sqrt(sum(float((v.grad.double() ** 2).sum())
                         for v in theta.values() if v.grad is not None))
    return float(loss.detach()), norm


def phase_card_vs_cpu() -> None:
    from neuralpde_tpu_torch.ops.sampling import uniform_random

    points = torch.Generator()

    def sampler(n, lb, ub, generator):
        """The same points for both runs, drawn on the CPU."""
        return uniform_random(n, lb.cpu(), ub.cpu(), points).to(lb.device)

    results = {}
    init = None
    for device in ("cpu", "cuda"):
        points.manual_seed(1)
        prob = bench_problem(CHECK_BATCH, CHECK_MICROBATCH, device,
                             init_params=init, sampler=sampler,
                             matmul_precision="highest")
        init = {k[len("depvar."):]: v.cpu()
                for k, v in prob.init_params.items()}
        results[device] = _loss_and_grad_norm(prob)
        torch.cuda.synchronize()
    (cpu_loss, cpu_norm), (gpu_loss, gpu_norm) = results["cpu"], results["cuda"]
    d_loss = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    d_norm = abs(gpu_norm - cpu_norm) / abs(cpu_norm)
    print(f"[card-vs-cpu] batch {CHECK_BATCH} microbatch {CHECK_MICROBATCH} "
          f"f32 highest: loss {gpu_loss:.9g} vs {cpu_loss:.9g} (rel "
          f"{d_loss:.2e}), grad norm {gpu_norm:.9g} vs {cpu_norm:.9g} (rel "
          f"{d_norm:.2e}); limits {CARD_VS_CPU_RTOL}")
    if not all(map(math.isfinite, (gpu_loss, gpu_norm, cpu_loss, cpu_norm))):
        raise AssertionError("card-vs-cpu: non-finite loss or gradient")
    if d_loss > CARD_VS_CPU_RTOL["loss"] or d_norm > CARD_VS_CPU_RTOL["grad_norm"]:
        raise AssertionError("card-vs-cpu: the card disagrees with the CPU")


def phase_main_path(card: str) -> dict:
    from neuralpde_tpu_torch import adam, make_step
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    prob = bench_problem(BATCH, MICROBATCH, "cuda")
    pinnrep = prob.pinnrep
    lf = pinnrep.loss_functions
    step = make_step(prob.loss, adam(1e-3), pinnrep.adaloss,
                     lf.pde_loss_functions, lf.bc_loss_functions,
                     matmul_precision=pinnrep.matmul_precision)
    ada = pinnrep.adaloss.init_state(1, 4, pinnrep.dtype, pinnrep.device)
    carry = step.init(prob.init_params, ada)
    generator = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    tj.reset_launch_counts()
    carry, (loss, _) = step(carry, generator)          # warm-up
    losses = [loss]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        carry, (loss, _) = step(carry, generator)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = tj.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    values = [float(v) for v in losses]
    points = BATCH + 4 * (BATCH // 8)
    pps = points * STEPS / dt
    print(f"[main] batch {BATCH} microbatch {MICROBATCH} mlp([2,{HIDDEN},"
          f"{HIDDEN},1]) jet Adam(1e-3) f32: {STEPS} steps in {dt:.3f} s, "
          f"{1e3 * dt / STEPS:.1f} ms/step, {pps:.6g} points/s, peak "
          f"{peak_gib:.2f} GiB; {card}")
    print(f"[main] losses {values[0]:.6g} -> {values[-1]:.6g}; "
          f"launches {counts}")
    _require_falling("main path", values)
    _require_launched("main path", counts, "tanh_jet2_forward",
                      "tanh_jet2_backward")
    _profile(step, carry, generator, dt / STEPS)
    return counts


def _require_falling(what: str, values) -> None:
    if not all(map(math.isfinite, values)):
        raise AssertionError(f"{what}: non-finite loss in {values}")
    if not np.mean(values[-5:]) < values[0]:
        raise AssertionError(f"{what}: loss did not fall: {values}")


def _require_launched(what: str, counts: dict, *names) -> None:
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"{what} never launched {name}")


def _profile(step, carry, generator, step_s: float) -> None:
    """Trace two main-path steps: the device's busy time per step against
    the untraced step time ``step_s``, and the kernels with the most device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            carry, _ = step(carry, generator)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_us = _kernel_us(prof)
    print(f"[profile] device busy {busy_us / 2e3:.2f} ms per step against "
          f"{step_s * 1e3:.2f} ms untraced: idle share "
          f"{1 - busy_us / 2e6 / step_s:.3f}")
    for e in kernels[:12]:
        print(f"[profile] {100 * e.self_device_time_total / busy_us:5.1f}% "
              f"{e.self_device_time_total / 2e3:8.3f} ms/step "
              f"{e.count // 2:6d} calls/step  {e.key[:90]}")


def _rel(got: dict, want: dict) -> float:
    """max |got - want| / max |want| over all entries of two dicts."""
    num = max(float((got[k] - want[k]).abs().max()) for k in want)
    return num / max(float(w.abs().max()) for w in want.values())


def phase_transforms(card: str) -> dict:
    """`torch.func.jvp` and `vjp` in the parameters of a Taylor-mode
    residual (tanh_jet2 forward, jvp and backward kernels) against the
    nested-jvp engine (plain ops), on the card."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.kernels import tanh_jet as tj
    from neuralpde_tpu_torch.nn.core import TrialFunction
    from torch.func import jvp, vjp

    g = torch.Generator().manual_seed(2)
    net = npde.mlp([2, HIDDEN, HIDDEN, 1], dtype=torch.float32)
    net.reset_parameters(g)
    theta = {k: v.detach().cuda() for k, v in net.named_parameters()}
    tangent = {k: torch.randn(v.shape, generator=g).cuda()
               for k, v in theta.items()}
    x = torch.rand((2, MICROBATCH), generator=g).cuda()
    cot = torch.randn((1, MICROBATCH), generator=g).cuda()

    def residual(engine):
        return lambda th: engine(TrialFunction(net, th), x, [0, 0], 2)

    jet, nested = (residual(npde.DerivativeEngine(m)) for m in ("jet", "jvp"))
    with npde.matmul_precision("highest"):
        tj.reset_launch_counts()
        t0 = time.perf_counter()
        jv = jvp(jet, (theta,), (tangent,))[1]
        uj = vjp(jet, theta)[1](cot)[0]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = tj.launch_counts()
        jv_ref = jvp(nested, (theta,), (tangent,))[1]
        uj_ref = vjp(nested, theta)[1](cot)[0]
    err_jvp = _rel({"r": jv}, {"r": jv_ref})
    err_vjp = _rel(uj, uj_ref)
    print(f"[transforms] mlp([2,{HIDDEN},{HIDDEN},1]) Dxx by jet, "
          f"{MICROBATCH} points, f32 highest: jvp rel {err_jvp:.3e}, vjp rel "
          f"{err_vjp:.3e} against the nested-jvp engine (limit "
          f"{TRANSFORM_RTOL}); {seconds:.3f} s; launches {counts}; {card}")
    if not (err_jvp <= TRANSFORM_RTOL and err_vjp <= TRANSFORM_RTOL):
        raise AssertionError("transforms: the jet route disagrees")
    _require_launched("transforms", counts, "tanh_jet2_forward",
                      "tanh_jet2_jvp", "tanh_jet2_backward")
    return counts


def phase_separable_card_vs_cpu() -> None:
    from neuralpde_tpu_torch.accuracy import poisson_spinn

    results, init = {}, None
    for device in ("cpu", "cuda"):
        prob, _ = poisson_spinn(SPINN_CHECK_N, HIDDEN, SPINN_RANK,
                                device=device, init_params=init,
                                matmul_precision="highest")
        init = {k[len("depvar."):]: v.cpu()
                for k, v in prob.init_params.items()}
        results[device] = _loss_and_grad_norm(prob)
        torch.cuda.synchronize()
    (cpu_loss, cpu_norm), (gpu_loss, gpu_norm) = results["cpu"], results["cuda"]
    d_loss = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    d_norm = abs(gpu_norm - cpu_norm) / abs(cpu_norm)
    print(f"[separable-card-vs-cpu] {SPINN_CHECK_N}^2 grid rank {SPINN_RANK} "
          f"f32 highest: loss {gpu_loss:.9g} vs {cpu_loss:.9g} (rel "
          f"{d_loss:.2e}), grad norm {gpu_norm:.9g} vs {cpu_norm:.9g} (rel "
          f"{d_norm:.2e}); limits {CARD_VS_CPU_RTOL}")
    if not all(map(math.isfinite, (gpu_loss, gpu_norm, cpu_loss, cpu_norm))):
        raise AssertionError("separable card-vs-cpu: non-finite values")
    if d_loss > CARD_VS_CPU_RTOL["loss"] or d_norm > CARD_VS_CPU_RTOL["grad_norm"]:
        raise AssertionError("separable card-vs-cpu: the card disagrees")


def phase_separable_main(card: str) -> dict:
    """bench.py's spinn_points_per_sec: 20 timed Adam steps on the 16384^2
    grid after one warm-up step, then two profiled steps."""
    from neuralpde_tpu_torch import adam, make_step
    from neuralpde_tpu_torch.accuracy import poisson_spinn
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    prob, _ = poisson_spinn(SPINN_N, HIDDEN, SPINN_RANK)
    pinnrep = prob.pinnrep
    step = make_step(prob.loss, adam(2e-3), pinnrep.adaloss,
                     matmul_precision=pinnrep.matmul_precision)
    carry = step.init(prob.init_params, pinnrep.adaloss.init_state(
        1, 0, pinnrep.dtype, pinnrep.device))
    generator = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tj.reset_launch_counts()
    carry, (loss, _) = step(carry, generator)          # warm-up
    losses = [loss]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SPINN_STEPS):
        carry, (loss, _) = step(carry, generator)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = tj.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    values = [float(v) for v in losses]
    pps = SPINN_N * SPINN_N * SPINN_STEPS / dt
    print(f"[spinn] {SPINN_N}^2 grid rank {SPINN_RANK} mlp([1,{HIDDEN},"
          f"{HIDDEN},{SPINN_RANK}]) hard Adam(2e-3) f32: {SPINN_STEPS} steps "
          f"in {dt:.3f} s, {1e3 * dt / SPINN_STEPS:.2f} ms/step, {pps:.6g} "
          f"points/s, peak {peak_gib:.2f} GiB; {card}")
    print(f"[spinn] losses {values[0]:.6g} -> {values[-1]:.6g}; "
          f"launches {counts}")
    _require_falling("separable main path", values)
    _require_launched("separable main path", counts, "tanh_jet2_forward",
                      "tanh_jet2_backward")
    _profile(step, carry, generator, dt / SPINN_STEPS)
    return counts


def phase_separable_accuracy(card: str) -> dict:
    """accuracy_suite item 1: 500 Adam steps on the 128^2 grid, for each of
    `SPINN_SEEDS` (the initial parameters)."""
    from neuralpde_tpu_torch.accuracy import poisson_spinn_rel_l2
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    tj.reset_launch_counts()
    runs = {seed: poisson_spinn_rel_l2(seed=seed) for seed in SPINN_SEEDS}
    counts = tj.launch_counts()
    for seed, r in runs.items():
        print(f"[spinn-accuracy] seed {seed}: {SPINN_CHECK_N}^2 grid, 500 "
              f"Adam(2e-3) steps in blocks of 100: {r['seconds']:.2f} s, "
              f"losses {r['history']}, rel L2 {r['rel_l2']:.4e}; {card}")
    rels = [r["rel_l2"] for r in runs.values()]
    got = {"median": float(np.median(rels)), "max": max(rels)}
    print(f"[spinn-accuracy] rel L2 over seeds {list(runs)}: median "
          f"{got['median']:.4e}, max {got['max']:.4e} (limits "
          f"{SPINN_REL_L2_LIMIT}; JAX reference on TPU v5e: "
          f"{JAX_RECORD['poisson_spinn_rel_l2']}); launches {counts}")
    if not (all(map(math.isfinite, rels)) and all(
            got[k] < limit for k, limit in SPINN_REL_L2_LIMIT.items())):
        raise AssertionError(f"separable accuracy: rel L2 {rels} beyond "
                             f"{SPINN_REL_L2_LIMIT}")
    return counts


def phase_gauss_newton(card: str) -> None:
    """accuracy_suite item 2: LM with LSQR, float64 scalars, on a float32
    separable problem.  Each outer iteration runs two LSQR steps as they
    are, captures one as a CUDA graph and replays it for the rest; a
    counter sees the captured launches once, not their replays, so this
    phase's counts stay out of the kernels line."""
    from neuralpde_tpu_torch import solve_gauss_newton
    from neuralpde_tpu_torch.accuracy import poisson_rel_l2, poisson_spinn
    from neuralpde_tpu_torch.gauss_newton import _EAGER_STEPS
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    prob, net = poisson_spinn(33, 24, 24)
    tj.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve_gauss_newton(prob, maxiters=GN_MAXITERS, cg_iters=GN_CG_ITERS,
                             solver="lsqr", scalar_dtype=torch.float64)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = tj.launch_counts()
    rel = poisson_rel_l2(net, res.u)
    hist = res.history
    print(f"[gauss-newton] mlp([1,24,24,24]) per axis, 33^2 grid, f32 "
          f"problem, LSQR {GN_CG_ITERS} iterations with f64 scalars: "
          f"{res.iterations} outer iterations in {seconds:.2f} s "
          f"({seconds / max(res.iterations, 1):.3f} s each); objective "
          f"{hist[0]:.4e} -> {hist[-1]:.4e}; rel L2 {rel:.4e} (JAX reference "
          f"on TPU v5e at 200 iterations: {JAX_RECORD['gn_rel_l2']}); "
          f"launches counted, eager and at capture: {counts}, besides "
          f"{res.iterations} x {GN_CG_ITERS - _EAGER_STEPS} uncounted graph "
          f"replays of one LSQR step; {card}")
    if not rel < 1e-3:
        raise AssertionError(f"gauss-newton: rel L2 {rel} >= 1e-3")
    _require_launched("gauss-newton", counts, "tanh_jet2_jvp",
                      "tanh_jet2_backward")


def phase_causal(card: str) -> dict:
    """bench.py's Allen-Cahn stage 1: 1000 Adam steps with causal weights."""
    from neuralpde_tpu_torch import adam, solve
    from neuralpde_tpu_torch.accuracy import allen_cahn_net, allen_cahn_stage
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    prob, strategy = allen_cahn_stage(allen_cahn_net(256), 100.0)
    ada = prob.pinnrep.adaloss.init_state(1, 1, torch.float32, "cuda")
    with torch.no_grad():
        loss0 = float(prob.loss(prob.init_params,
                                {"generator": None, "adaptive": ada})[0])
        w0 = strategy.causal_weights(prob.init_params)[0]
    tj.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(prob, adam(1e-3), maxiters=1000, inner_steps=1000)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = tj.launch_counts()
    with torch.no_grad():
        w = strategy.causal_weights(res.u)[0].double().cpu().numpy()
    print(f"[causal] Allen-Cahn stage 1, 256^2 grid, rank 256, causal_eps "
          f"100, Adam(1e-3) 1000 steps: {seconds:.2f} s; loss {loss0:.5g} -> "
          f"{res.objective:.5g}; last causal weight {float(w0[-1]):.3g} -> "
          f"{w[-1]:.3g}; launches {counts}; {card}")
    if not (math.isfinite(res.objective) and res.objective < loss0):
        raise AssertionError(f"causal: loss {loss0} -> {res.objective}")
    if not (w[0] == 1.0 and np.all(np.diff(w) <= 0)):
        raise AssertionError(f"causal: weights not non-increasing in t: {w}")
    return counts


def _timed(label: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[{label}] phase took {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    name, smi = phase_device()
    card = f"card: {smi}"
    _timed("build", phase_build)
    kernels = _timed("kernel", phase_kernels, card)
    runs = {4: lambda: phase_card_vs_cpu(),
            5: lambda: phase_main_path(card),
            6: lambda: phase_transforms(card),
            7: lambda: phase_separable_card_vs_cpu(),
            8: lambda: phase_separable_main(card),
            9: lambda: phase_separable_accuracy(card),
            10: lambda: phase_gauss_newton(card),
            11: lambda: phase_causal(card)}
    totals: dict = {}
    for number, run in runs.items():
        counts = _timed(f"phase {number}", run)
        for k, n in (counts or {}).items():
            totals[k] = totals.get(k, 0) + n
    for k in kernels:
        k["launches"] = totals[k["name"]]
    print(json.dumps({"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms", "plain_ms")}
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
