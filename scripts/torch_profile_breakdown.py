"""Op-level device-time breakdown of a training step of the PyTorch port on
one NVIDIA H100: the twin of `scripts/profile_breakdown.py`.

The step is `solve`'s captured CUDA graph, as `bench_torch.py` times it.
One `solve` runs four blocks of ``steps`` steps: the first holds the eager
step and the capture, the second is timed untraced (``wall_s``,
``points_per_sec``), the third warms `torch.profiler` up (its first
traced graph launch stalls the host for milliseconds), the fourth is
traced (CPU and CUDA activity) from one block callback to the next
(``traced_wall_s``).  Every device event of the trace falls into one
class of `CLASSES` by its kernel name (`classify`), in place of the JAX
script's join against the compiled HLO.

Printed, in order: one JSON line ``{"tag", "points_per_sec", "wall_s",
"traced_wall_s", "device_busy_ms", "idle_share", "categories", "device",
"power_limit"}`` (``device_busy_ms`` and each class's ms are a step's;
the busy time is the union of the device events' intervals, so the
classes sum to it unless kernels overlap); each class's ms and share of
the busy time; the 15 kernels with the most device time, with their
calls a step; the five longest idle gaps between device events, each
with the host operation open at its start.  ``idle_share`` is one less
the busy time over the traced block's step time, both read in the same
window; ``traced_wall_s`` over ``wall_s`` is what tracing costs.
``power_limit`` is the card's in watts.

Configurations (the JAX script's): dense 2-D Poisson ``mlp([2, 64, 64,
1])``, batch 524,288 in microbatches of 32,768 (default); ``--w128``:
batch 32,768 unchunked at width 128; ``--spinn``: the separable net on a
16384^2 grid at rank 64.  20 steps, Adam 1e-3, float32 with TF32 off.
Needs a CUDA card; without one it raises.

    python3 scripts/torch_profile_breakdown.py [--spinn|--w128]
"""

from __future__ import annotations

import collections
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:    # the port, when this file runs as a script
    sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
import neuralpde_tpu_torch as npde  # noqa: E402
from neuralpde_tpu_torch import accuracy  # noqa: E402

STEPS = 20
CLASSES = ("gemm", "hand_written", "elementwise", "reduce", "copy/layout",
           "rng", "nccl", "other")
# lower-case name fragments of each class, tried in this order: a class
# earlier in the list wins (a cuBLAS split-K reduction and a GEMV are
# matrix products, a Philox draw runs in an elementwise kernel, a copy or
# an index copy too)
_MARKS = (("nccl", ("nccl",)),
          ("hand_written", ("tanh_jet2", "zoom_step", "set_conditional")),
          ("gemm", ("gemm", "xmma", "sm90_", "cutlass", "splitkreduce",
                    "gemv")),
          ("rng", ("philox", "distribution_elementwise")),
          ("copy/layout", ("memcpy", "memset", "copy", "catarray", "index",
                           "gather", "scatter", "transpose")),
          ("reduce", ("reduce", "cub::")),
          ("elementwise", ("elementwise", "foreach", "multi_tensor_apply")))
TOP = 15
GAPS = 5
SUM_RTOL = 0.01     # the classes' sum against the busy time
KEYS = ("tag", "points_per_sec", "wall_s", "traced_wall_s", "device_busy_ms",
        "idle_share", "categories", "device", "power_limit")


def classify(name: str) -> str:
    """The class (`CLASSES`) of a device event from its kernel name."""
    low = name.lower()
    for cls, marks in _MARKS:
        if any(m in low for m in marks):
            return cls
    return "other"


def build_dense(batch: int = 524_288, microbatch: int | None = 32_768,
                hidden: int = 64, *, dtype=torch.float32, device="cuda",
                init_params=None):
    """The JAX script's ``build_dense``: bench's dense 2-D Poisson problem
    (`bench_torch.poisson_problem`, jet).  Returns the problem and the
    points a step, ``batch + 4 * (batch // 8)``."""
    prob = bench_torch.poisson_problem(batch, hidden, microbatch=microbatch,
                                       dtype=dtype, device=device,
                                       init_params=init_params)
    return prob, batch + 4 * (batch // 8)


def build_spinn(n: int = 16_384, rank: int = 64, hidden: int = 64, *,
                dtype=torch.float32, device="cuda", init_params=None):
    """The JAX script's ``build_spinn``: the hard-constrained separable net
    on an n x n grid (`accuracy.poisson_spinn`).  Returns the problem and
    the grid points a step."""
    bench_torch.require_card(device)
    prob, _ = accuracy.poisson_spinn(n, hidden, rank, dtype=dtype,
                                     device=device, init_params=init_params)
    return prob, n * n


def traced_solve(prob, steps: int):
    """One `solve` of four blocks of ``steps`` Adam(1e-3) steps: the
    seconds of the second (untraced) and of the fourth, and the profiler
    that traced the fourth (the third warms the profiler up).  A block's
    seconds run between block callbacks, whose read of the loss waits for
    the card; the fourth's start once the profiler records."""
    from torch.profiler import ProfilerActivity, profile, schedule

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    stamps = []

    def callback(it, loss, aux):
        stamps.append(time.perf_counter())
        if len(stamps) == 2:
            prof.start()
        elif len(stamps) == 3:
            prof.step()
            stamps[-1] = time.perf_counter()
        elif len(stamps) == 4:
            torch.cuda.synchronize()
            prof.stop()

    npde.solve(prob, npde.adam(1e-3), maxiters=4 * steps, inner_steps=steps,
               callback=callback)
    return stamps[1] - stamps[0], stamps[3] - stamps[2], prof


def _union(intervals):
    """Merge (start, end) intervals: the merged list, sorted."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def breakdown(prof, steps: int, step_s: float) -> dict:
    """The device time of ``steps`` traced steps by class and by kernel,
    against the traced window's step time ``step_s`` (seconds).  ``prof`` is a
    stopped `torch.profiler.profile` (anything whose ``events()`` gives
    events with ``name``, ``device_type`` and ``time_range`` in us).

    Returns ``{"device_busy_ms", "idle_share", "categories": {class: ms},
    "kernels": [(name, ms, calls a step, class)] (the `TOP` longest),
    "gaps": [(ms, host operation open at its start)] (the `GAPS`
    longest)}``, times a step except the gaps'."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            # a range annotating device work would count its kernels twice
            if not getattr(e, "is_user_annotation", False):
                device.append(e)
        elif e.device_type == DeviceType.CPU:
            host.append(e)
    categories = dict.fromkeys(CLASSES, 0.0)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        us = e.time_range.end - e.time_range.start
        categories[classify(e.name)] += us
        by_name[e.name][0] += us
        by_name[e.name][1] += 1
    busy = _union((e.time_range.start, e.time_range.end) for e in device)
    busy_ms = sum(end - start for start, end in busy) / 1e3 / steps

    def open_at(t):
        ops = [e for e in host if e.time_range.start <= t < e.time_range.end]
        return max(ops, key=lambda e: e.time_range.start).name if ops else None

    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:GAPS]
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (1e3 * step_s),
        "categories": {k: v / 1e3 / steps for k, v in categories.items()},
        "kernels": [(name, us / 1e3 / steps, calls / steps, classify(name))
                    for name, (us, calls) in kernels],
        "gaps": [(us / 1e3, open_at(t)) for us, t in gaps],
    }


def classes_sum_to_busy(line: dict) -> bool:
    """Whether a breakdown's classes sum to its busy time within
    `SUM_RTOL`: every device event classified once, and no two overlapping
    by more."""
    busy = line["device_busy_ms"]
    return abs(sum(line["categories"].values()) - busy) <= SUM_RTOL * busy


def report(bd: dict, prefix: str = "") -> None:
    """Print a `breakdown`: each class's ms a step and share of the busy
    time, the longest kernels, the longest idle gaps."""
    busy = bd["device_busy_ms"]
    print(f"{prefix}device busy {busy:.3f} ms a step, idle share "
          f"{bd['idle_share']:.4f}; classes sum to "
          f"{sum(bd['categories'].values()):.3f} ms")
    for cls, ms in sorted(bd["categories"].items(), key=lambda kv: -kv[1]):
        share = 100 * ms / busy if busy else 0.0
        print(f"{prefix}  {cls:14s} {ms:9.3f} ms  {share:5.1f}%")
    print(f"{prefix}top kernels (ms a step, calls a step):")
    for name, ms, calls, cls in bd["kernels"]:
        print(f"{prefix}  {ms:9.3f} ms {calls:8.2f}  {cls:12s} {name[:90]}")
    print(f"{prefix}longest idle gaps (ms, host operation open at the "
          f"start):")
    for ms, op in bd["gaps"]:
        print(f"{prefix}  {ms:9.4f} ms  {op}")


def run(tag: str = "dense", steps: int = STEPS, device="cuda") -> dict:
    """Build the configuration ``tag`` ("dense", "w128", "spinn"), time and
    trace its replayed step, print the JSON line and the breakdown, and
    return the line with the breakdown's kernels and gaps."""
    bench_torch.require_card(device)
    if tag == "spinn":
        prob, points = build_spinn(device=device)
    elif tag == "w128":
        prob, points = build_dense(32_768, None, 128, device=device)
    else:
        prob, points = build_dense(device=device)
    wall, traced, prof = traced_solve(prob, steps)
    bd = breakdown(prof, steps, traced / steps)
    card = bench_torch.card_fields(device)
    line = {"tag": tag, "points_per_sec": points * steps / wall,
            "wall_s": wall, "traced_wall_s": traced,
            "device_busy_ms": bd["device_busy_ms"],
            "idle_share": bd["idle_share"], "categories": bd["categories"],
            "device": card["device"], "power_limit": card["power_limit_w"]}
    print(json.dumps(line), flush=True)
    report(bd)
    return {**line, "kernels": bd["kernels"], "gaps": bd["gaps"]}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    run("spinn" if "--spinn" in argv else
        "w128" if "--w128" in argv else "dense")


if __name__ == "__main__":
    main()
