"""Steady data-parallel training steps of one fixed problem over several
cards, one process a card.

This process is rank 0: it starts the other ranks (this file's
`rank_main` through ``run.py --rank-of``), which join a process group over
TCP on localhost (NCCL on cards, gloo on the CPU) and train under the
program's ``make_mesh()``: every rank draws the global sample from the same
generator, keeps its slice, and the step all-reduces the gradients once,
inside its captured graph.  Each rank runs one ``solve`` of one step a
block: the first ``check_steps`` steps are set-up and are held to the
reference on rank 0 (the loss and gradients are the summed global ones);
``calibration_steps`` more steps time a step on rank 0, which then tells
every rank the number of window steps that fills ``--seconds``; after a
barrier the window runs them, timed on rank 0's clock from the barrier to
its last step's callback.  A traced run then traces one block of a fresh
``solve`` on every rank (`harness.traced_block`).  Rank 0 gathers every rank's memory peak and traced
busy time, and prints the line once the others have exited.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import time

import torch

import harness
import problems

CHILD_TIMEOUT_S = 120       # after rank 0's own run, for the others to exit


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(ctx) -> dict:
    world = ctx.workload["ranks"]
    port = free_port()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    children = []
    for rank in range(1, world):
        blob = {"workload": ctx.cell.name, "seed": ctx.seed,
                "seconds": ctx.seconds, "trace": ctx.trace,
                "device": torch.device(ctx.device).type, "rank": rank,
                "world": world, "port": port,
                "overrides": ctx.overrides, "preload": ctx.preload}
        children.append(subprocess.Popen(
            [sys.executable, os.path.join(here, "run.py"), "--rank-of",
             json.dumps(blob)], stdout=sys.stderr, stdin=subprocess.DEVNULL))
    try:
        out = rank_main(ctx, 0, world, port)
        codes = [c.wait(timeout=CHILD_TIMEOUT_S) for c in children]
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    if any(codes):
        raise RuntimeError(f"ranks 1..{world - 1} exited with {codes}")
    return out


def _device(ctx, rank: int):
    if torch.device(ctx.device).type == "cuda":
        return torch.device("cuda", rank)
    return torch.device("cpu")


def rank_main(ctx, rank: int, world: int, port: int):
    """One rank's run; rank 0 returns the driver's outcome, the others
    None."""
    import torch.distributed as dist

    from neuralpde_tpu_torch.parallel.distributed import (
        initialize_distributed)

    npde, wl = ctx.npde, ctx.workload
    device = _device(ctx, rank)
    initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                           device=device)
    try:
        mesh = npde.make_mesh(device=device)
        problem = problems.problem_of(ctx.config, wl)
        params_seed, points_seed = problems.seeds(ctx.seed, 2)
        init = problems.init_params(problem, params_seed, device)
        with npde.use_mesh(mesh):
            prob = problems.build(npde, problem, init, device)
            prob = prob.with_params(npde.replicate_params(prob.init_params,
                                                          mesh))
            held = harness.HeldOptimizer(npde, problem["optimizer"]["lr"])
            first = harness.FirstSteps(held, prob, init, wl["check_steps"])
            generator = torch.Generator(device=device).manual_seed(
                points_seed)
            res, st = train(ctx, prob, held, first, generator, device, rank)
            mine = {"peak": (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else None),
                    "busy_s": None, "window_s": None, "breakdown": None}
            if ctx.trace:
                bd = harness.traced_block(
                    npde, prob, res.u, problem["optimizer"]["lr"],
                    wl["trace_steps"], points_seed + 1, device)
                mine.update(busy_s=bd["busy_s"], window_s=bd["window_s"],
                            breakdown=bd if rank == 0 else None)
        gathered = [None] * world
        dist.all_gather_object(gathered, mine)
        graphs = res.aux.get("cuda_graph", {})
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return None
    stamps, t0, failed = st["stamps"], st["t0"], st["failed"]
    window_s = stamps[-1] - t0
    steps = len(stamps)
    harness.log(f"window: {steps} steps in {window_s:.6f} s on rank 0; "
                f"captures {graphs}; last loss {res.objective}")
    fields = harness.card_fields(world, device)
    if device.type == "cuda":
        fields["memory_peak_bytes"] = max(g["peak"] for g in gathered)
    layer = {"capture_setup_s": graphs.get("capture_seconds"),
             "breakdown": gathered[0]["breakdown"],
             "trace_steps": wl["trace_steps"]}
    if ctx.trace:
        layer["busy_s"] = sum(g["busy_s"] for g in gathered) / world
        layer["window_s"] = sum(g["window_s"] for g in gathered) / world
    del res, prob, st
    held.opt = None
    harness.free(device)
    reference = problems.follow_reference(problem, init, points_seed,
                                          wl["check_steps"])
    return {
        "e2e": {"dp_points_per_s": problems.counted_points(problem) * steps
                / window_s, "setup_s": t0 - ctx.t_start},
        "attempted": steps, "failed": failed, "program": first.readings(),
        "reference": reference, "device": fields, "layer": layer,
    }


def train(ctx, prob, held, first, generator, device, rank: int):
    """The rank's window ``solve``: (result, {"t0", "stamps", "failed",
    ...})."""
    import torch.distributed as dist

    wl = ctx.workload
    st = {"phase": "check", "t0": None, "stamps": [], "failed": 0,
          "calibrate": [], "window_steps": None}

    def callback(it, loss, aux):
        now = time.perf_counter()
        phase = st["phase"]
        if phase == "check":
            if first.record(loss):
                st["phase"] = "calibrate"
                st["calibrate"].append(now)
            return False
        if phase == "calibrate":
            st["calibrate"].append(now)
            if len(st["calibrate"]) <= wl["calibration_steps"]:
                return False
            step_s = ((st["calibrate"][-1] - st["calibrate"][0])
                      / wl["calibration_steps"])
            n = torch.tensor([max(1, math.ceil(ctx.seconds / step_s))],
                             dtype=torch.int64, device=device)
            dist.broadcast(n, src=0)
            st["window_steps"] = int(n)
            dist.barrier()
            st["phase"], st["t0"] = "window", time.perf_counter()
            return False
        st["stamps"].append(now)
        st["failed"] += not math.isfinite(loss)
        return len(st["stamps"]) >= st["window_steps"]

    res = ctx.npde.solve(prob, held, maxiters=1 << 40, inner_steps=1,
                         callback=callback, generator=generator)
    if st["t0"] is None or len(st["stamps"]) < (st["window_steps"] or 1):
        raise RuntimeError(f"rank {rank}: the solve stopped early (losses "
                           f"{first.losses}, {len(st['stamps'])} window "
                           "steps)")
    return res, st
