"""Steady training steps at a fixed batch on one card.

One ``solve`` of the cell's problem runs one step a block: its first
``check_steps`` steps (the eager step, the capture, the first replays) are
set-up and are held to the reference; the window then replays the
captured step for ``--seconds``.  The rate is the counted points of every step in the window over
the window, from the callback that closes set-up to the callback of the
window's last step, each after the step's loss was read from the card.
A step whose loss is not finite fails (``solve`` stops there).  A traced
run then traces one block of a fresh ``solve`` from the window's
parameters (`harness.traced_block`).
"""

from __future__ import annotations

import math
import time

import torch

import harness
import problems


def train(ctx, prob, held, first, generator):
    """Run the one ``solve``: (result, {"t0": window start, "stamps": each
    window step's end, "failed"})."""
    st = {"phase": "check", "t0": None, "stamps": [], "failed": 0}

    def callback(it, loss, aux):
        now = time.perf_counter()
        if st["phase"] == "check":
            ctx.mark(f"step {it} read")
            if first.record(loss):
                st["phase"], st["t0"] = "window", now
            return False
        st["stamps"].append(now)
        st["failed"] += not math.isfinite(loss)
        return now - st["t0"] >= ctx.seconds

    res = ctx.npde.solve(prob, held, maxiters=1 << 40, inner_steps=1,
                         callback=callback, generator=generator)
    return res, st


def run(ctx) -> dict:
    npde, device, wl = ctx.npde, ctx.device, ctx.workload
    problem = problems.problem_of(ctx.config, wl)
    params_seed, points_seed = problems.seeds(ctx.seed, 2)
    init = problems.init_params(problem, params_seed, device)
    prob = problems.build(npde, problem, init, device)
    ctx.mark("problem built")
    held = harness.HeldOptimizer(npde, problem["optimizer"]["lr"])
    first = harness.FirstSteps(held, prob, init, wl["check_steps"])
    generator = torch.Generator(device=device).manual_seed(points_seed)
    res, st = train(ctx, prob, held, first, generator)
    stamps, t0, failed = st["stamps"], st["t0"], st["failed"]
    if t0 is None or not stamps:
        raise RuntimeError("the solve stopped before the window began "
                           f"(losses {first.losses})")
    window_s = stamps[-1] - t0
    steps = len(stamps)
    graphs = res.aux.get("cuda_graph", {})
    harness.log(f"window: {steps} steps in {window_s:.6f} s; captures "
                f"{graphs}; last loss {res.objective}")
    layer = {
        "step_s": window_s / steps,
        "model_flops": problems.model_flops(problem),
        "capture_setup_s": graphs.get("capture_seconds"),
        "breakdown": None,
        "trace_steps": wl["trace_steps"],
    }
    fields = harness.card_fields(1, device)
    if ctx.trace:
        layer["breakdown"] = harness.traced_block(
            npde, prob, res.u, problem["optimizer"]["lr"], wl["trace_steps"],
            points_seed + 1, device)
    layer["launch_shapes"] = ctx.launch_shapes()
    # the program's state goes before the reference runs
    del res, prob, st
    held.opt = None
    harness.free(device)
    ctx.mark("reference starts")
    reference = problems.follow_reference(problem, init, points_seed,
                                          wl["check_steps"])
    ctx.mark("reference done")
    return {
        "e2e": {"points_per_s": problems.counted_points(problem) * steps
                / window_s,
                "setup_s": t0 - ctx.t_start},
        "attempted": steps, "failed": failed, "program": first.readings(),
        "reference": reference, "device": fields, "layer": layer,
    }
