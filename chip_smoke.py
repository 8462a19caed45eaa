#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`neuralpde_tpu_torch`) on one CUDA card.

Run from the root of a checkout:

    python3 chip_smoke.py

It drives the port's main path, the 2-D Poisson trainer of `bench.py`'s
headline (mlp([2, 64, 64, 1]), Taylor-mode derivatives, stochastic batch of
2,097,152 points in microbatches of 32,768, Adam), in phases that each print
one line and raise on failure:

1. device: the card's name, and nvidia-smi's name and power limit;
2. build: the kernel library from `neuralpde_tpu_torch/csrc/` with nvcc;
3. kernel vs plain: each kernel against its plain PyTorch version at the
   main path's shape, in float32 and float64, with both times;
4. card vs CPU: one loss and gradient of the bench problem at batch 32,768,
   same parameters and points, on the card (kernels) and the CPU (plain);
5. main path: one warm-up step and 20 timed steps through `make_step`,
   then two steps traced by `torch.profiler`: the device's idle share of a
   step and its device time by kernel.

Then one JSON line of kernels, and the last line
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
KERNEL_SHAPE = (HIDDEN, MICROBATCH)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.float64: dict(rtol=1e-12, atol=1e-12)}
CARD_VS_CPU_RTOL = {"loss": 1e-5, "grad_norm": 1e-4}


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
        z, z1, z2, ga, ga1, ga2 = (
            2 * torch.randn(KERNEL_SHAPE, generator=g, dtype=dtype,
                            device="cuda") for _ in range(6))
        cases = {
            "tanh_jet2_forward": (
                lambda: tj.tanh_jet2_forward_cuda(z, z1, z2),
                lambda: tj.tanh_jet2_reference(z, z1, z2)),
            "tanh_jet2_backward": (
                lambda: tj.tanh_jet2_backward_cuda(z, z1, z2, ga, ga1, ga2),
                lambda: tj.tanh_jet2_backward_reference(z, z1, z2, ga, ga1,
                                                        ga2)),
        }
        for name, (kernel, plain) in cases.items():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, **TOL[dtype])
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ms, plain_ms = _in_turns(_device_ms, plain, kernel)
            call_ms, plain_call_ms = _in_turns(_event_ms, plain, kernel)
            print(f"[kernel] {name} {str(dtype)[6:]} {KERNEL_SHAPE}: "
                  f"max_abs_err {err:.3e} (tolerance {TOL[dtype]}); device "
                  f"time kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; per "
                  f"call with launch kernel {call_ms:.4f} ms, plain "
                  f"{plain_call_ms:.4f} ms; {card}")
            if dtype == torch.float32:
                results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
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
    ada = pinnrep.adaloss.init_state(1, 4, pinnrep.dtype, pinnrep.device)
    with matmul_precision(pinnrep.matmul_precision):
        loss, _ = prob.loss(theta, {"generator": None, "adaptive": ada})
        loss.backward()
    norm = math.sqrt(sum(float((v.grad.double() ** 2).sum())
                         for v in theta.values()))
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


def _reset_counts(tj) -> None:
    tj.tanh_jet2.launches = 0
    tj.tanh_jet2_forward_cuda.launches = 0
    tj.tanh_jet2_backward_cuda.launches = 0


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

    _reset_counts(tj)
    carry, (loss, _) = step(carry, generator)          # warm-up
    losses = [loss]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        carry, (loss, _) = step(carry, generator)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {"tanh_jet2_forward": tj.tanh_jet2_forward_cuda.launches,
              "tanh_jet2_backward": tj.tanh_jet2_backward_cuda.launches}
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
    if not all(map(math.isfinite, values)):
        raise AssertionError(f"main path: non-finite loss in {values}")
    if not np.mean(values[-5:]) < values[0]:
        raise AssertionError(f"main path: loss did not fall: {values}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")
    _profile(step, carry, generator, dt / STEPS)
    return counts


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


def main() -> int:
    name, smi = phase_device()
    card = f"card: {smi}"
    phase_build()
    kernels = phase_kernels(card)
    phase_card_vs_cpu()
    counts = phase_main_path(card)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    print(json.dumps({"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms", "plain_ms")}
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
