"""`bench.py` in the PyTorch port: collocation points/sec of the 2-D Poisson
PINN training step on one NVIDIA H100, and bench's other modes.

    python3 bench_torch.py                 # the default JSON line
    python3 bench_torch.py --spinn         # one mode (list below)

The default run prints ONE JSON line on stdout with every key of `bench.py`'s
line: ``value`` (points/s of the dense w64 step), ``vs_baseline``,
``tflops`` and ``mfu_pct``; the same for the separable (SPINN) step
(``spinn_*``) and the w128 and w256 dense steps; the accuracy suite
(``poisson_spinn_*``, ``gn_*``, ``allen_cahn_*``).  The step is the port's
main path: `solve`'s captured CUDA graph of a jet step, whose tanh rule is the
hand-written ``tanh_jet2`` kernels.  Numbers are unrounded.

Precision.  ``value`` and the ``spinn_*`` rates run at the port's default,
true float32 (``matmul_precision=None``, TF32 off), the accuracy the JAX
package's records rest on.  bench's ``dense_highest_*``/``spinn_highest_*``
priced true float32 against the TPU's default bf16 passes; here the other
precision is TF32 (``matmul_precision="high"``), so those keys become
``dense_tf32_*``/``spinn_tf32_*`` (`RENAMED`), and ``*_speedup`` is the TF32
rate over the float32 one.  No field runs TF32 unless its name says tf32.

FLOPs and MFU.  FLOPs a point come from `torch.utils.flop_counter.
FlopCounterMode` over one un-captured step of the unchunked twin at batch
32,768 (bench's convention: FLOPs a point do not depend on the batch, and
neither chunking nor remat counts).  The counter sees the matmul family
only; ``tanh_jet2`` and the elementwise work are not counted, where XLA's
cost analysis counts them, so the port's ``tflops`` do not compare with the
JAX records' figures.  ``mfu_pct`` is the run's GEMM TFLOP/s as a share of
the published dense peak of one H100 SXM at 700 W for the precision the step
ran at: 67 TFLOP/s float32, 495 TFLOP/s TF32.  It is not divided by the
measured ceiling: a share of a cuBLAS-measured ceiling passes 100% once a
hand-written kernel beats cuBLAS on thin GEMMs.  The ceilings are on the
line all the same (``fp32_ceiling_tflops``, ``tf32_ceiling_tflops``: the
8192^3 chains of `scripts/torch_probe_matmul_peak.py`, measured in the same
process), with the card's name and power limit (``device``,
``power_limit_w``, as nvidia-smi reads them).

``vs_baseline`` divides by a baseline measured in the same process (the
``--baseline`` workload: float64, finite-difference derivatives, batch 4096,
one CPU thread, on this machine's CPU): the median rate of five windows of
two seconds after a warm-up window, printed on stderr with each window's
rate and the CPU model.  One CPU thread of a shared host is noisier than
the card, so the ratio carries the baseline's spread.

Timing.  `solve` captures its step anew at each call, so a rate is the time
between the block callbacks of one `solve` of two blocks: the first block
holds the eager first step and the capture (stderr prints the capture
seconds), the second replays the graph ``steps`` times.  The host clock ends
at the callback's read of the loss, which waits for the card.

Modes (each prints bench's line for it; a target missed prints null):
``--to-l2``, ``--to-l2-hard``, ``--to-l2-hybrid``, ``--to-l2-spinn``
(seconds to RMS < 1e-3; progress on stderr), ``--spinn``, ``--burgers``,
``--baseline`` (on the CPU by design), ``--sweep`` (remat, dtypes, hybrid),
``--accuracy``, ``--accuracy-dense`` (~44 minutes) and ``--accuracy-full``
(the full separable Allen-Cahn, dense Allen-Cahn and Beltrami recipes, hours).
Everything else needs a CUDA card and raises without one; the functions take
``device="cpu"`` for the tests.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import platform
import statistics
import sys
import time

import torch

import neuralpde_tpu_torch as npde
from neuralpde_tpu_torch import accuracy

BATCH = 2_097_152
MICROBATCH = 32_768
HIDDEN = 64
STEPS_MEASURE = 20
# wider nets at bench's batches and microbatches (width, batch, microbatch)
WIDTHS = ((128, 1_048_576, 8_192), (256, 262_144, 8_192))
FLOPS_BATCH = 32_768            # the unchunked twin whose FLOPs are counted
SPINN_N = 16_384
SPINN_RANK = 64
BASELINE_BATCH = 4_096
BASELINE_WINDOW_S = 2.0         # least seconds of a window of baseline steps
BASELINE_WINDOWS = 5            # timed windows after a warm-up, their median
CEILING_SIZE = 8_192            # the square chain of the ceilings
CEILING_REPS = 20
# the probe's type (`PEAK_TFLOPS` key) of each `matmul_precision` a step
# runs at
PRECISION_TYPE = {None: "float32", "high": "tf32"}
# bench.py's keys that name the TPU's precision pair, and the port's names
RENAMED = {"dense_highest_points_per_sec": "dense_tf32_points_per_sec",
           "dense_highest_cost": "dense_tf32_speedup",
           "spinn_highest_points_per_sec": "spinn_tf32_points_per_sec",
           "spinn_highest_cost": "spinn_tf32_speedup"}
# bench.py's throughput keys as the port names them: `throughput_fields`
# returns these and ADDED, `accuracy_suite` the rest of the line
THROUGHPUT_KEYS = (
    "metric", "value", "unit", "vs_baseline", "tflops", "mfu_pct",
    "spinn_points_per_sec", "spinn_vs_baseline", "spinn_tflops",
    "spinn_mfu_pct", "w128_points_per_sec", "w128_tflops", "w128_mfu_pct",
    "w256_points_per_sec", "w256_tflops", "w256_mfu_pct",
    *RENAMED.values())
# keys of the port's line that bench's has not
ADDED = ("dense_tf32_tflops", "dense_tf32_mfu_pct", "spinn_tf32_tflops",
         "spinn_tf32_mfu_pct", "fp32_ceiling_tflops", "tf32_ceiling_tflops",
         "device", "power_limit_w")


def require_card(device) -> None:
    """Raise where ``device`` is the card and there is none (the port's
    measurement scripts never carry on on the CPU)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card (torch.cuda.is_available() is "
                           "False); the functions take device='cpu' for "
                           "tests")


@functools.cache
def _probe():
    """`scripts/torch_probe_matmul_peak.py`, the matmul-ceiling probe."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "torch_probe_matmul_peak.py")
    spec = importlib.util.spec_from_file_location("torch_probe_matmul_peak",
                                                  path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


# ---------------------------------------------------------------------------
# bench's problems
# ---------------------------------------------------------------------------

def _dense_problem(system, batch: int, hidden: int, *, microbatch, dtype,
                   device, init_params, **kw):
    """``system`` on ``mlp([2, hidden, hidden, 1])`` with
    ``StochasticTraining(batch, bcs_points=batch // 8, microbatch)``."""
    require_card(device)
    return npde.discretize(system, npde.PhysicsInformedNN(
        npde.mlp([2, hidden, hidden, 1], dtype=dtype),
        npde.StochasticTraining(batch, bcs_points=batch // 8,
                                microbatch=microbatch),
        dtype=dtype, device=device, init_params=init_params, **kw))


def poisson_problem(batch: int, hidden: int = HIDDEN, *,
                    microbatch: int | None = None, derivative: str = "jet",
                    remat: bool = False, dtype=torch.float32, accum=None,
                    matmul_precision: str | None = None, device="cuda",
                    init_params=None):
    """bench's dense 2-D Poisson problem (`accuracy.poisson_2d_system`) on
    `_dense_problem`'s net and strategy."""
    return _dense_problem(accuracy.poisson_2d_system(), batch, hidden,
                          microbatch=microbatch, dtype=dtype, device=device,
                          init_params=init_params, derivative=derivative,
                          remat=remat, loss_accum_dtype=accum,
                          matmul_precision=matmul_precision)


def burgers_problem(batch: int, hidden: int = HIDDEN, *,
                    microbatch: int | None = None, dtype=torch.float32,
                    device="cuda", init_params=None):
    """bench's 1-D Burgers problem, ``u_t + u u_x = 0.05 u_xx`` on [-1, 1] x
    [0, 1] with ``u(x, 0) = -sin(pi x)`` and zero at both ends
    (`accuracy.burgers_dgm_example`), jet, on `_dense_problem`'s net and
    strategy."""
    return _dense_problem(accuracy.burgers_dgm_example(), batch, hidden,
                          microbatch=microbatch, dtype=dtype, device=device,
                          init_params=init_params, derivative="jet")


def _step(prob, optimizer):
    """A `make_step` of ``prob`` and its first carry."""
    rep = prob.pinnrep
    lf = rep.loss_functions
    step = npde.make_step(prob.loss, optimizer, rep.adaloss,
                          lf.pde_loss_functions, lf.bc_loss_functions,
                          matmul_precision=rep.matmul_precision)
    return step, step.init(prob.init_params, rep.adaloss.init_state(
        len(lf.pde_loss_functions), len(lf.bc_loss_functions), rep.dtype,
        rep.device))


def step_flops(prob, optimizer) -> float:
    """GEMM FLOPs of one eager step of ``prob`` (`FlopCounterMode`)."""
    from torch.utils.flop_counter import FlopCounterMode

    step, carry = _step(prob, optimizer)
    generator = torch.Generator(device=prob.pinnrep.device).manual_seed(0)
    with FlopCounterMode(display=False) as counter:
        step(carry, generator)
    return float(counter.get_total_flops())


def block_seconds(prob, optimizer, steps: int, blocks: int,
                  what: str) -> list[float]:
    """Seconds of each block of ``steps`` steps after the first of one
    `solve` of ``blocks`` blocks, replayed from its captured graph (the
    first block holds the eager step, the capture and a replay, so
    ``steps`` >= 2 and ``blocks`` >= 2).  A block's time runs between the
    block callbacks, whose read of the loss waits for the card."""
    if steps < 2 or blocks < 2:
        raise ValueError(f"steps and blocks must be at least 2, got {steps} "
                         f"and {blocks}")
    stamps = []
    t0 = time.perf_counter()
    res = npde.solve(prob, optimizer, maxiters=blocks * steps,
                     inner_steps=steps,
                     callback=lambda it, loss, aux: stamps.append(
                         (time.perf_counter(), loss)))
    seconds = [b[0] - a[0] for a, b in zip(stamps, stamps[1:])]
    print(f"[bench_torch] {what}: first block {stamps[0][0] - t0:.3f} s "
          f"(eager step, capture, replays; captures and their seconds "
          f"{res.aux.get('cuda_graph')}), then blocks of {steps} steps in "
          f"{', '.join(f'{s:.4f}' for s in seconds)} s; losses "
          f"{stamps[0][1]:.6g} -> {stamps[-1][1]:.6g}", file=sys.stderr)
    return seconds


def timed_steps(prob, optimizer, steps: int, what: str) -> float:
    """Seconds of ``steps`` steps replayed from `solve`'s captured graph:
    the second of two blocks of ``steps`` (`block_seconds`)."""
    return block_seconds(prob, optimizer, steps, 2, what)[0]


def poisson_pps(batch: int, hidden: int = HIDDEN, remat: bool = False,
                dtype=torch.float32, accum=None, steps: int = STEPS_MEASURE,
                microbatch: int | None = None,
                matmul_precision: str | None = None, device="cuda") -> float:
    """Points/s of the dense Poisson step (bench's ``_poisson_pps``),
    counted as bench counts them: ``batch + 4 * (batch // 8)`` a step."""
    prob = poisson_problem(batch, hidden, microbatch=microbatch, remat=remat,
                           dtype=dtype, accum=accum,
                           matmul_precision=matmul_precision, device=device)
    seconds = timed_steps(
        prob, npde.adam(1e-3), steps,
        f"poisson batch {batch} microbatch {microbatch} w{hidden} "
        f"{dtype} accum {accum} remat {remat} "
        f"matmul_precision {matmul_precision}")
    return (batch + 4 * (batch // 8)) * steps / seconds


def flops_per_point(hidden: int, batch: int = FLOPS_BATCH,
                    device="cuda") -> float:
    """GEMM FLOPs a counted point of one dense step (bench's
    ``_flops_per_point``), from the unchunked twin at ``batch``."""
    prob = poisson_problem(batch, hidden, device=device)
    return step_flops(prob, npde.adam(1e-3)) / (batch + 4 * (batch // 8))


def spinn_points_per_sec(n: int = SPINN_N, rank: int = SPINN_RANK,
                         steps: int = STEPS_MEASURE,
                         matmul_precision: str | None = None,
                         device="cuda") -> float:
    """Grid points/s of the separable (SPINN) step on an n x n grid at
    ``rank`` (`accuracy.poisson_spinn`, Adam(2e-3))."""
    require_card(device)
    prob, _ = accuracy.poisson_spinn(n, HIDDEN, rank, device=device,
                                     matmul_precision=matmul_precision)
    seconds = timed_steps(prob, npde.adam(2e-3), steps,
                          f"spinn {n}^2 rank {rank} matmul_precision "
                          f"{matmul_precision}")
    return n * n * steps / seconds


def spinn_flops_per_point(n: int = SPINN_N, rank: int = SPINN_RANK,
                          device="cuda") -> float:
    """GEMM FLOPs a grid point of one eager step of the SPINN problem of
    `spinn_points_per_sec`."""
    require_card(device)
    prob, _ = accuracy.poisson_spinn(n, HIDDEN, rank, device=device)
    return step_flops(prob, npde.adam(2e-3)) / (n * n)


def burgers_points_per_sec(batch: int = BATCH, device="cuda") -> float:
    """Points/s of the Burgers step (bench's ``burgers_points_per_sec``):
    ``batch + 3 * (batch // 8)`` a step, microbatch MICROBATCH."""
    prob = burgers_problem(batch, microbatch=MICROBATCH, device=device)
    seconds = timed_steps(prob, npde.adam(1e-3), STEPS_MEASURE,
                          f"burgers batch {batch} microbatch {MICROBATCH}")
    return (batch + 3 * (batch // 8)) * STEPS_MEASURE / seconds


def measure_cpu_baseline(batch: int = BASELINE_BATCH) -> float:
    """Points/s of the reference-equivalent workload on one CPU thread
    (bench's ``measure_cpu_baseline``): the dense Poisson step at width 64,
    float64, finite-difference derivatives, Adam.  Steps run in windows of
    at least BASELINE_WINDOW_S seconds, a warm-up window, then
    BASELINE_WINDOWS timed ones; returns their median rate and prints each
    window's rate and the CPU model on stderr.  Runs on the CPU by
    design."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        prob = poisson_problem(batch, derivative="fd", dtype=torch.float64,
                               device="cpu")
        step, carry = _step(prob, npde.adam(1e-3))
        generator = torch.Generator().manual_seed(0)
        rates = []
        for _ in range(1 + BASELINE_WINDOWS):
            steps, t0 = 0, time.perf_counter()
            while True:
                carry, (loss, _) = step(carry, generator)
                float(loss)
                steps += 1
                seconds = time.perf_counter() - t0
                if seconds >= BASELINE_WINDOW_S:
                    break
            rates.append((batch + 4 * (batch // 8)) * steps / seconds)
    finally:
        torch.set_num_threads(threads)
    pps = statistics.median(rates[1:])
    print(f"[bench_torch] baseline (float64, fd, batch {batch}, one CPU "
          f"thread) {pps!r} points/s, the median of windows {rates[1:]!r} "
          f"(warm-up {rates[0]!r}) on {cpu_model()}", file=sys.stderr)
    return pps


def card_fields(device="cuda") -> dict:
    """``{"device", "power_limit_w"}``: the card's as nvidia-smi reads them;
    on the CPU its model and no power limit."""
    if torch.device(device).type == "cuda":
        require_card(device)
        return _probe().card()
    return {"device": cpu_model(), "power_limit_w": None}


def _mfu_fields(flops_per_point: float, pps: float, precision,
                prefix: str = "") -> dict:
    tflops = flops_per_point * pps / 1e12
    peak = _probe().PEAK_TFLOPS[PRECISION_TYPE[precision]]
    return {prefix + "tflops": tflops,
            prefix + "mfu_pct": 100.0 * tflops / peak}


def throughput_fields(*, hidden: int = HIDDEN, batch: int = BATCH,
                      microbatch: int | None = MICROBATCH, widths=WIDTHS,
                      spinn_n: int = SPINN_N, spinn_rank: int = SPINN_RANK,
                      steps: int = STEPS_MEASURE,
                      flops_batch: int = FLOPS_BATCH,
                      baseline_batch: int = BASELINE_BATCH,
                      ceiling_size: int = CEILING_SIZE,
                      device="cuda") -> dict:
    """Every field of the default line but the accuracy suite's, at bench's
    sizes unless told otherwise."""
    require_card(device)
    baseline = measure_cpu_baseline(baseline_batch)
    pps = poisson_pps(batch, hidden, steps=steps, microbatch=microbatch,
                      device=device)
    fpp = flops_per_point(hidden, flops_batch, device=device)
    spinn = spinn_points_per_sec(spinn_n, spinn_rank, steps, device=device)
    spinn_fpp = spinn_flops_per_point(spinn_n, spinn_rank, device=device)
    fields = {
        "metric": "2d_poisson_collocation_points_per_sec",
        "value": pps,
        "unit": "points/sec",
        "vs_baseline": pps / baseline,
        **_mfu_fields(fpp, pps, None),
        "spinn_points_per_sec": spinn,
        "spinn_vs_baseline": spinn / baseline,
        **_mfu_fields(spinn_fpp, spinn, None, "spinn_"),
    }
    for width, wbatch, wmicro in widths:
        rate = poisson_pps(wbatch, width, steps=steps, microbatch=wmicro,
                           device=device)
        fields[f"w{width}_points_per_sec"] = rate
        fields.update(_mfu_fields(flops_per_point(width, flops_batch,
                                                  device=device),
                                  rate, None, f"w{width}_"))
    dense_tf32 = poisson_pps(batch, hidden, steps=steps,
                             microbatch=microbatch, matmul_precision="high",
                             device=device)
    spinn_tf32 = spinn_points_per_sec(spinn_n, spinn_rank, steps,
                                      matmul_precision="high", device=device)
    fields.update({
        "dense_tf32_points_per_sec": dense_tf32,
        "dense_tf32_speedup": dense_tf32 / pps,
        **_mfu_fields(fpp, dense_tf32, "high", "dense_tf32_"),
        "spinn_tf32_points_per_sec": spinn_tf32,
        "spinn_tf32_speedup": spinn_tf32 / spinn,
        **_mfu_fields(spinn_fpp, spinn_tf32, "high", "spinn_tf32_"),
    })
    for kind, key in (("float32", "fp32_ceiling_tflops"),
                      ("tf32", "tf32_ceiling_tflops")):
        fields[key] = _probe().chain_tflops(ceiling_size, ceiling_size,
                                            ceiling_size, kind, CEILING_REPS,
                                            device)[0]
    fields.update(card_fields(device))
    return fields


def accuracy_suite(*, poisson_steps: int = 500, gn_iters: int = 200,
                   gn_cg_iters: int = 200, ac_rank: int = 256,
                   ac_nodes: int = 256, ac_iters: int = 15_000,
                   device="cuda") -> dict:
    """bench's ``accuracy_suite`` from `neuralpde_tpu_torch.accuracy`: the
    hard-constrained SPINN Poisson (500 Adam steps on 128^2), Gauss-Newton
    (200 outer iterations of 200 LSQR steps on 33^2) and the causal
    separable Allen-Cahn (three stages of 15,000 Adam steps); rel L2 and
    seconds of each.  As in bench, an untimed SPINN solve of 100 steps
    first takes the process's one-time costs (the kernels' build, the CUDA
    and cuBLAS set-up); the seconds hold each solve's graph captures."""
    require_card(device)
    accuracy.poisson_spinn_rel_l2(maxiters=min(100, poisson_steps),
                                  device=device)
    spinn = accuracy.poisson_spinn_rel_l2(maxiters=poisson_steps,
                                          device=device)
    gn = accuracy.gauss_newton_rel_l2(maxiters=gn_iters, cg_iters=gn_cg_iters,
                                      device=device)
    ac = accuracy.allen_cahn_rel_l2(rank=ac_rank, nodes=ac_nodes,
                                    iters=ac_iters, device=device)
    return {"poisson_spinn_rel_l2": spinn["rel_l2"],
            "poisson_spinn_seconds": spinn["seconds"],
            "gn_seconds": gn["seconds"], "gn_rel_l2": gn["rel_l2"],
            "allen_cahn_seconds": ac["seconds"],
            "allen_cahn_rel_l2": ac["rel_l2"]}


# ---------------------------------------------------------------------------
# The modes
# ---------------------------------------------------------------------------

def _to_l2_line(tag: str, metric: str, result: dict):
    """bench's stderr progress of a to-accuracy recipe, from its trace, then
    one JSON line (``value`` null where the target was missed)."""
    for it, err, seconds in result["trace"]:
        print(f"[{tag}] iter={it} l2={err:.2e} t={seconds:.2f}s",
              file=sys.stderr)
    if result["seconds"] is None:
        print(f"[{tag}] did not reach target (final {result['rms']:.2e})",
              file=sys.stderr)
    else:
        print(f"[{tag}] reached L2<1e-3 in {result['seconds']:.2f}s "
              f"({result['iterations']} iters)", file=sys.stderr)
    print(json.dumps({"metric": metric, "value": result["seconds"],
                      "unit": "seconds", "rms": result["rms"],
                      "iterations": result["iterations"]}), flush=True)


def spinn_line(device="cuda") -> None:
    """``--spinn``: bench's SPINN line."""
    baseline = measure_cpu_baseline()
    pps = spinn_points_per_sec(device=device)
    print(json.dumps({
        "metric": "2d_poisson_spinn_collocation_points_per_sec",
        "value": pps, "unit": "points/sec", "vs_baseline": pps / baseline,
        **_mfu_fields(spinn_flops_per_point(device=device), pps, None),
        "note": f"separable (SPINN) trial fn, {SPINN_N}x{SPINN_N} grid, rank "
                f"{SPINN_RANK}, hard-constrained BCs, float32",
        **card_fields(device)}))


def burgers_line(device="cuda") -> None:
    """``--burgers``: bench's Burgers line."""
    baseline = measure_cpu_baseline()
    pps = burgers_points_per_sec(device=device)
    print(json.dumps({"metric": "1d_burgers_collocation_points_per_sec",
                      "value": pps, "unit": "points/sec",
                      "vs_baseline": pps / baseline, **card_fields(device)}))


def baseline_line() -> None:
    """``--baseline``: the baseline denominator, a CPU number."""
    print(json.dumps({
        "metric": "cpu_f64_fd_2d_poisson_points_per_sec",
        "value": measure_cpu_baseline(), "unit": "points/sec",
        "note": "measured baseline denominator (single CPU thread)",
        "cpu": cpu_model()}))


def sweep(device="cuda") -> None:
    """bench's ``sweep``: remat off and on at three unchunked batches; the
    float32, float32 with float64 accumulation and float64 step at 8192;
    the hybrid recipe's seconds to RMS < 1e-3.  One JSON line each."""
    for batch in (32_768, 131_072, 524_288):
        for remat in (False, True):
            pps = poisson_pps(batch, remat=remat,
                              steps=20 if batch >= 131_072 else 50,
                              device=device)
            print(json.dumps({"metric": "poisson_pps", "batch": batch,
                              "remat": remat, "value": pps}), flush=True)
    for name, dtype, accum in (("f32", torch.float32, None),
                               ("f32+f64accum", torch.float32, torch.float64),
                               ("f64", torch.float64, None)):
        pps = poisson_pps(8_192, dtype=dtype, accum=accum, steps=10,
                          device=device)
        print(json.dumps({"metric": "dtype_pps", "config": name,
                          "batch": 8_192, "value": pps}), flush=True)
    r = accuracy.time_to_l2_hybrid(device=device)
    print(json.dumps({"metric": "hybrid_to_l2_seconds",
                      "value": r["seconds"]}), flush=True)


def accuracy_dense(device="cuda") -> dict:
    """``--accuracy-dense``: bench's ``accuracy_dense_full`` line from
    `accuracy.dense_allen_cahn` (no warm-up solves: the port compiles
    nothing)."""
    r = accuracy.dense_allen_cahn(device=device)
    out = {"metric": "accuracy_dense_full",
           "allen_cahn_dense_rel_l2": r["rel_l2"],
           "allen_cahn_dense_wall_s": r["seconds"],
           "allen_cahn_dense_per_stage": [[s["eps"], s["rel_l2"]]
                                          for s in r["per_stage"]]}
    print(json.dumps(out), flush=True)
    return out


def accuracy_full(device="cuda") -> None:
    """``--accuracy-full``: bench's ``accuracy_full`` through the ported
    examples' ``run()``: separable Allen-Cahn (4 x 75,000 steps), the dense
    recipe, Beltrami 65^4 (3 x 20,000); a line after each."""
    from neuralpde_tpu_torch.examples import allen_cahn_spinn, beltrami_spinn

    out = {"metric": "accuracy_full"}
    ac = allen_cahn_spinn.run(device=device)
    out.update(allen_cahn_full_rel_l2=ac["rel_l2"],
               allen_cahn_full_wall_s=ac["wall_s"],
               allen_cahn_full_per_stage=[list(s) for s in ac["per_stage"]])
    print(json.dumps(out), flush=True)
    dn = accuracy_dense(device)
    out.update(allen_cahn_dense_rel_l2=dn["allen_cahn_dense_rel_l2"],
               allen_cahn_dense_wall_s=dn["allen_cahn_dense_wall_s"])
    print(json.dumps(out), flush=True)
    bl = beltrami_spinn.run(device=device)
    out.update(beltrami_full_rel_l2=bl["rel_l2"],
               beltrami_full_wall_s=bl["wall_s"],
               beltrami_full_per_stage=[list(s) for s in bl["per_stage"]])
    print(json.dumps(out), flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if "--baseline" in argv:
        baseline_line()
        return
    require_card("cuda")
    if "--to-l2" in argv:
        _to_l2_line("to-l2", "to_l2_seconds", accuracy.time_to_l2())
    elif "--burgers" in argv:
        burgers_line()
    elif "--sweep" in argv:
        sweep()
    elif "--to-l2-hybrid" in argv:
        _to_l2_line("hybrid", "hybrid_to_l2_seconds",
                    accuracy.time_to_l2_hybrid())
    elif "--to-l2-hard" in argv:
        _to_l2_line("hard", "hard_to_l2_seconds", accuracy.time_to_l2_hard())
    elif "--spinn" in argv:
        spinn_line()
    elif "--to-l2-spinn" in argv:
        _to_l2_line("spinn", "spinn_to_l2_seconds",
                    accuracy.time_to_l2_spinn())
    elif "--accuracy-full" in argv:
        accuracy_full()
    elif "--accuracy-dense" in argv:
        accuracy_dense()
    elif "--accuracy" in argv:
        print(json.dumps({"metric": "accuracy_suite", **accuracy_suite()}))
    else:
        print(json.dumps({**throughput_fields(), **accuracy_suite()}))


if __name__ == "__main__":
    main()
